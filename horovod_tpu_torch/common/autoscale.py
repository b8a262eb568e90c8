"""Telemetry-driven autoscaling — the elastic driver's decision layer;
the port's copy of ``horovod_tpu/common/autoscale.py``.

Workers publish per-rank step-time summaries over the rendezvous KV,
and a policy engine in the elastic driver turns them into ``keep |
grow(n) | shrink(host) | evict(host)`` decisions that flow through the
driver's ``HostManager`` blacklist and its host-update channel.

* :class:`AutoscalePolicy` — every threshold, window and hysteresis knob
  as data (``--autoscale-policy file|inline-json``,
  ``HVD_TPU_AUTOSCALE_<FIELD>`` env overrides). Validation errors name
  the bad field.
* :func:`note_step` / :class:`StepPublisher` — the worker side, hooked
  into ``State.commit()``: a rolling step-time summary (p50/mean over a
  window, plus recovery counters) published to the KV under
  ``autoscale/steptime.<rank>``. The ``straggler`` fault site fires
  here.
* :class:`AutoscaleEngine` — the driver side: on a periodic tick and
  before each epoch it evaluates the freshest reports and decides
  (evict a straggler after ``straggler_patience`` flagged ticks, shrink a
  stalled or diverging host, grow onto returned or new capacity, keep),
  never taking a voluntary reshape below ``min_np``. Every decision
  bumps ``hvd_tpu_autoscale_decisions_total{action=}``; every non-keep
  decision is appended to the JSON-lines decision log
  (``HVD_TPU_AUTOSCALE_LOG``) with deterministic fields only, so a
  seeded run replays to a byte-identical log.

**What the port's step time measures.** The JAX publisher reports the
wall time between commits. Its FORCE_LOCAL hosts were worlds of their
own, so a slow host really had the longer interval. The port's hosts
are ranks of ONE gloo world: a rank that sleeps delays every rank at
the next collective, and the interval between commits is the same on
all of them. So the port's publisher reports each rank's BUSY time: the
interval less the seconds the rank spent blocked in collectives
(:data:`comm_clock` — the optimizer's ``synchronize()`` and the eager
engine's waits), which is what differs between a slow rank and the
ranks waiting for it. While the publisher is live, the optimizer first
waits for its own device's work, so a rank's slow card counts as its
busy time, not as a wait. The report's fields and the engine are the JAX
package's. ``comm_fraction`` is the window's blocked share of the
interval.

The role-aware parts of the JAX engine (replica-grouped scoring, a
whole-replica floor, the ``respec`` action) need a hybrid ParallelSpec,
which comes with the parallel-roles slice of the port: asking for one
raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import metrics as metrics_lib
from .config import runtime_env

logger = logging.getLogger("horovod_tpu_torch")

ENV_ENABLE = "HVD_TPU_AUTOSCALE"        # truthy: enable the control loop
ENV_POLICY = "HVD_TPU_AUTOSCALE_POLICY"  # policy file path or inline JSON
ENV_LOG = "HVD_TPU_AUTOSCALE_LOG"       # driver-side decision log (JSONL)

KV_SCOPE = "autoscale"                  # rendezvous KV scope for reports

ACTIONS = ("keep", "grow", "shrink", "evict", "respec")
_ROLES_SLICE = "the parallel-roles slice"

# Pre-seeding every action at 0 makes "no decision yet" distinguishable
# from "metrics broken" on the very first scrape.
_M_DECISIONS = metrics_lib.counter(
    "hvd_tpu_autoscale_decisions_total",
    "autoscale decisions by action (keep/grow/shrink/evict)",
    labels=("action",))
for _a in ACTIONS:
    _M_DECISIONS.labels(action=_a)
del _a
_M_STRAGGLERS = metrics_lib.gauge(
    "hvd_tpu_autoscale_stragglers",
    "hosts currently flagged as stragglers by the autoscale engine")
_M_STEP_P50 = metrics_lib.gauge(
    "hvd_tpu_autoscale_step_time_seconds",
    "this worker's rolling-window p50 step time as published to the "
    "autoscale control plane (per-worker registry; exported samples "
    "carry the registry's rank=/size= GLOBAL labels once hvd.init() "
    "stamps them)")
_M_STEPS = metrics_lib.counter(
    "hvd_tpu_autoscale_steps_total",
    "commits observed by the step publisher — the advancing per-rank "
    "step counter the pod aggregator's SCRAPE path reads in place of "
    "the KV report's step field")


def _truthy(raw: Optional[str]) -> bool:
    return (raw or "").strip().lower() in ("1", "true", "yes", "on")


# -- the policy: thresholds as data ------------------------------------------

@dataclasses.dataclass
class AutoscalePolicy:
    """Every autoscaling threshold, window, and hysteresis knob — data,
    not code (the JAX package's fields and defaults)."""

    enabled: bool = True
    # Cadence: driver evaluation tick; worker publication rate limit.
    tick_interval_s: float = 5.0
    publish_interval_s: float = 1.0
    # Worker-side rolling window (steps) the published p50/mean cover.
    window: int = 32
    # Straggler detection (driver): a host is flagged when its advancing
    # ranks' p50 exceeds ratio x median-of-rank-p50s; evicted after
    # `patience` consecutive flagged scoring ticks. Scoring needs at
    # least `min_ranks` ranks advancing in the same tick — a 2-rank
    # world cannot tell who is slow.
    straggler_ratio: float = 1.5
    straggler_patience: int = 2
    min_ranks: int = 3
    # Eviction: TTL blacklist (the host may recover — HostManager's
    # strike doubling applies on repeat failures); after
    # `evict_permanent_after` engine evictions of the SAME host the
    # exile is permanent (0 = never escalate).
    evict_ttl_s: float = 300.0
    evict_permanent_after: int = 0
    evict_cooldown_s: float = 10.0
    # Growth: adopt new/recovered capacity only when the measured comm
    # fraction (from StepTimer phase telemetry, when published) is at
    # least this (0 = always grow); at most one grow per cooldown.
    grow_min_comm_fraction: float = 0.0
    grow_cooldown_s: float = 30.0
    # Persistent stall: no rank of a host advanced for this long while
    # some other host did (0 = off).
    stall_timeout_s: float = 0.0
    # Evict permanently once HostManager records this many blacklist
    # strikes against a host (0 = off).
    max_blacklist_strikes: int = 0
    # Shrink a rank's host once its published divergence-resync counter
    # grows by this much (0 = off).
    max_divergence_resyncs: int = 0
    # Hard world floor for VOLUNTARY reshapes (evict/shrink). 0 = the
    # driver's --min-np wins.
    min_np: int = 0

    @classmethod
    def field_names(cls) -> Tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(cls))

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "AutoscalePolicy":
        """Build from a dict, with validation errors that NAME the bad
        field — a typo'd threshold must not silently fall back to the
        default."""
        if not isinstance(data, dict):
            raise ValueError(
                f"autoscale policy must be a JSON object, got "
                f"{type(data).__name__}")
        known = cls.field_names()
        unknown = sorted(set(data) - set(known))
        if unknown:
            raise ValueError(
                f"autoscale policy: unknown field(s) {unknown}; known "
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
                    f"autoscale policy: field {name!r} must be a "
                    f"{type(default).__name__}, got {value!r}")
            setattr(policy, name, value)
        policy.validate()
        return policy

    def validate(self) -> "AutoscalePolicy":
        for name in ("tick_interval_s", "publish_interval_s",
                     "evict_ttl_s", "evict_cooldown_s", "grow_cooldown_s",
                     "stall_timeout_s", "grow_min_comm_fraction"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"autoscale policy: field {name!r} must be >= 0, "
                    f"got {getattr(self, name)}")
        for name in ("window", "straggler_patience", "min_ranks"):
            if getattr(self, name) < 1:
                raise ValueError(
                    f"autoscale policy: field {name!r} must be >= 1, "
                    f"got {getattr(self, name)}")
        if self.straggler_ratio <= 1.0:
            raise ValueError(
                "autoscale policy: field 'straggler_ratio' must be "
                f"> 1.0 (a ratio at/below 1 flags every rank), got "
                f"{self.straggler_ratio}")
        for name in ("evict_permanent_after", "max_blacklist_strikes",
                     "max_divergence_resyncs", "min_np"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"autoscale policy: field {name!r} must be >= 0 "
                    f"(0 disables), got {getattr(self, name)}")
        return self

    def resolve_min_np(self, engine_min_np: int) -> int:
        """The effective voluntary-reshape floor: the policy's
        ``min_np`` when set, else the driver's."""
        return self.min_np if self.min_np > 0 else int(engine_min_np)

    @classmethod
    def from_json(cls, text: str) -> "AutoscalePolicy":
        try:
            data = json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"autoscale policy: invalid JSON ({e})")
        return cls.from_dict(data)

    @classmethod
    def load(cls, source: str) -> "AutoscalePolicy":
        """``source`` is a file path or inline JSON (a leading ``{``
        or ``@path`` disambiguates; bare paths just get read)."""
        source = source.strip()
        if source.startswith("@"):
            with open(source[1:]) as f:
                return cls.from_json(f.read())
        if source.startswith("{"):
            return cls.from_json(source)
        with open(source) as f:
            return cls.from_json(f.read())

    @classmethod
    def from_env(cls, env=None) -> "AutoscalePolicy":
        """HVD_TPU_AUTOSCALE_POLICY (file or inline JSON) as the base,
        then any ``HVD_TPU_AUTOSCALE_<FIELD>`` env knob overrides its
        field. ``env`` defaults to ``os.environ`` (the driver passes a
        merged view that includes the launcher's knobs)."""
        env = os.environ if env is None else env
        raw = env.get(ENV_POLICY) or _config_fallback("autoscale_policy")
        policy = cls.load(raw) if raw else cls()
        overrides: Dict[str, Any] = {}
        for name in cls.field_names():
            val = env.get("HVD_TPU_AUTOSCALE_" + name.upper())
            if val is not None:
                overrides[name] = val
        if overrides:
            merged = dataclasses.asdict(policy)
            merged.update(overrides)
            policy = cls.from_dict(merged)
        return policy

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)


def _config_fallback(field: str):
    """The initialized runtime's Config value for an autoscale knob
    (``init(autoscale=...)``), or None before init / in the driver
    process."""
    try:
        from . import basics

        if basics.is_initialized():
            return getattr(basics.context().config, field)
    except Exception:  # noqa: BLE001 — config is a fallback, not a dep
        pass
    return None


def autoscale_enabled(env=None) -> bool:
    """The control loop runs when HVD_TPU_AUTOSCALE is truthy, an
    explicit policy is installed (HVD_TPU_AUTOSCALE_POLICY /
    --autoscale-policy), or the initialized runtime's Config says so
    (``init(autoscale=True)``). HVD_TPU_AUTOSCALE=0 force-disables
    either way."""
    env = os.environ if env is None else env
    raw = env.get(ENV_ENABLE)
    if raw is not None:
        return _truthy(raw)
    if env.get(ENV_POLICY):
        return True
    return bool(_config_fallback("autoscale")
                or _config_fallback("autoscale_policy"))


# -- worker side: step-time publication over the controller KV ---------------

@dataclasses.dataclass
class StepReport:
    """One worker's published step-time summary (the KV record)."""

    rank: int
    host: str
    step: int                    # monotonically increasing commit count
    n: int                       # samples in the window
    p50: float
    mean: float
    last: float
    comm_fraction: Optional[float] = None
    resyncs: int = 0             # divergence_resyncs from RecoveryStats
    t: float = 0.0               # worker wall time at publication
    role: Optional[str] = None   # "dp1/pp0/tp1" under a hybrid spec

    @classmethod
    def from_json(cls, raw: bytes) -> Optional["StepReport"]:
        try:
            d = json.loads(raw.decode())
            return cls(rank=int(d["rank"]), host=str(d.get("host", "")),
                       step=int(d["step"]), n=int(d.get("n", 0)),
                       p50=float(d["p50"]), mean=float(d.get("mean", 0.0)),
                       last=float(d.get("last", 0.0)),
                       comm_fraction=d.get("comm_fraction"),
                       resyncs=int(d.get("resyncs", 0)),
                       t=float(d.get("t", 0.0)),
                       role=(str(d["role"]) if d.get("role") else None))
        except (ValueError, KeyError, TypeError, UnicodeDecodeError):
            return None  # a torn/foreign record must not kill the engine

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        for opt in ("comm_fraction", "role"):
            if d.get(opt) is None:
                d.pop(opt, None)
        return json.dumps(d, sort_keys=True)


def _comm_fraction_from_metrics() -> Optional[float]:
    """Comm share of step time from the StepTimer phase histogram
    (``optim.StepTimer``); None otherwise — the grow gate treats absent
    data as not-provably-comm-bound."""
    try:
        snap = metrics_lib.snapshot().get("hvd_tpu_step_phase_seconds")
        if not snap:
            return None
        total = comm = 0.0
        for s in snap["samples"]:
            v = s["value"]["sum"]
            total += v
            if s["labels"].get("phase") == "comm":
                comm += v
        if total <= 0:
            return None
        return comm / total
    except Exception:  # noqa: BLE001 — telemetry is best-effort
        return None


class CommClock:
    """Seconds this process spent blocked in collectives, summed over
    the threads that wait. :meth:`waiting` brackets one wait; nested
    brackets on one thread count once. The step publisher subtracts
    the growth between two commits from the commit interval."""

    def __init__(self):
        self._lock = threading.Lock()
        self._total = 0.0
        self._tls = threading.local()

    @contextlib.contextmanager
    def waiting(self):
        depth = getattr(self._tls, "depth", 0)
        self._tls.depth = depth + 1
        t0 = time.monotonic()
        try:
            yield
        finally:
            self._tls.depth = depth
            if depth == 0:
                dt = time.monotonic() - t0
                with self._lock:
                    self._total += dt

    def active(self) -> bool:
        """Whether this thread is inside a :meth:`waiting` bracket."""
        return getattr(self._tls, "depth", 0) > 0

    def total(self) -> float:
        with self._lock:
            return self._total


#: The process's collective-wait clock.
comm_clock = CommClock()


class StepPublisher:
    """Measures each commit interval (one ``note()`` per
    ``State.commit()``) less the time spent blocked in collectives
    (``comm_seconds``, default :data:`comm_clock`), keeps a rolling
    window, and publishes the summary to the rendezvous KV under
    ``autoscale/steptime.<rank>``. The ``straggler`` fault site fires
    here: ``delay_s`` sleeps for real (an honest slow worker), ``scale``
    inflates only the report."""

    def __init__(self, client, rank: int, host: str,
                 window: int = 32, publish_interval_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 role: Optional[str] = None,
                 comm_seconds: Optional[Callable[[], float]] = None):
        self._client = client
        self.rank = rank
        self.host = host
        self.role = role
        self._window = deque(maxlen=max(1, int(window)))
        self._comm_window = deque(maxlen=max(1, int(window)))
        self._interval = publish_interval_s
        self._clock = clock
        self._comm = (comm_seconds if comm_seconds is not None
                      else comm_clock.total)
        self._last_t: Optional[float] = None
        self._last_comm = 0.0
        self._last_publish = -float("inf")
        self._step = 0
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls) -> Optional["StepPublisher"]:
        """Build from the driver-exported env (HVD_TPU_AUTOSCALE +
        HVD_TPU_RENDEZVOUS); None when the control loop is off — the
        ``note_step`` hot path then stays a None check."""
        if not autoscale_enabled():
            return None
        rdv = runtime_env("RENDEZVOUS")
        if not rdv:
            return None
        try:
            policy = AutoscalePolicy.from_env()
        except (ValueError, OSError) as e:
            logger.warning("autoscale: bad policy, publisher disabled "
                           "(%s)", e)
            return None
        if not policy.enabled:
            return None
        from ..runner.rendezvous import RendezvousClient

        host, port = rdv.rsplit(":", 1)
        # Best-effort client: NO retries and a short timeout. The
        # publish runs inside State.commit(): a retrying client would
        # stall the step on a KV blip, and the inflated interval it
        # publishes next could get this healthy host flagged as a
        # straggler (telemetry must not manufacture the signal it
        # measures). A dropped report is harmless: the next commit
        # publishes again.
        client = RendezvousClient(host, int(port), timeout_s=2.0,
                                  retries=0)
        return cls(client,
                   rank=int(runtime_env("PROC_ID", "0")),
                   host=runtime_env("HOSTNAME", ""),
                   window=policy.window,
                   publish_interval_s=policy.publish_interval_s)

    def note(self) -> None:
        from . import faults as faults_lib

        spec = faults_lib.maybe_straggler()
        if spec is not None and spec.delay_s > 0:
            # A REAL injected straggler: the sleep lands inside the
            # interval this note measures, outside any collective.
            time.sleep(spec.delay_s)
        now = self._clock()
        comm_now = self._comm()
        with self._lock:
            if self._last_t is None:
                self._last_t, self._last_comm = now, comm_now
                return
            interval = now - self._last_t
            comm = min(max(comm_now - self._last_comm, 0.0), interval)
            self._last_t, self._last_comm = now, comm_now
            dt = interval - comm
            if spec is not None and spec.scale > 0:
                dt *= spec.scale  # report-only inflation (simulation)
            self._window.append(dt)
            self._comm_window.append((comm, interval))
            self._step += 1
            _M_STEPS.inc()
            if now - self._last_publish < self._interval:
                return
            self._last_publish = now
            report = self._build_report(dt)
        self._publish(report)

    def _comm_fraction(self) -> Optional[float]:
        total = sum(i for _, i in self._comm_window)
        if total <= 0:
            return _comm_fraction_from_metrics()
        return sum(c for c, _ in self._comm_window) / total

    def _build_report(self, last_dt: float) -> StepReport:
        import statistics

        vals = list(self._window)
        p50 = statistics.median(vals)
        _M_STEP_P50.set(p50)
        from . import faults as faults_lib

        resyncs = faults_lib.stats.snapshot().get("divergence_resyncs", 0)
        return StepReport(
            rank=self.rank, host=self.host, step=self._step,
            n=len(vals), p50=p50,
            mean=sum(vals) / len(vals), last=last_dt,
            comm_fraction=self._comm_fraction(),
            resyncs=int(resyncs), t=self._clock(), role=self.role)

    def _publish(self, report: StepReport) -> None:
        try:
            self._client.put(KV_SCOPE, f"steptime.{report.rank}",
                             report.to_json().encode())
        except OSError as e:  # the KV may be mid-restart — never fatal
            logger.debug("autoscale: publish failed (%s)", e)


_publisher: Optional[StepPublisher] = None
_publisher_checked = False
_publisher_lock = threading.Lock()


def note_step() -> None:
    """Per-commit hook (called by ``State.commit()``): measure the step
    and publish the rolling summary. A no-op (one bool + None check
    after the first call) unless the driver enabled autoscaling for
    this job."""
    global _publisher, _publisher_checked
    if not _publisher_checked:
        with _publisher_lock:
            if not _publisher_checked:
                _publisher = StepPublisher.from_env()
                _publisher_checked = True
    if _publisher is not None:
        _publisher.note()


def publishing() -> bool:
    """Whether this process's step publisher is live (the elastic driver
    runs autoscaling and a commit has built it)."""
    return _publisher is not None


def _reset_publisher_for_tests() -> None:
    global _publisher, _publisher_checked
    with _publisher_lock:
        _publisher = None
        _publisher_checked = False


# -- driver side: the decision engine ----------------------------------------

@dataclasses.dataclass
class Decision:
    """One engine decision. ``seq`` counts NON-KEEP decisions (the
    deterministic decision-log sequence); keeps carry seq 0."""

    action: str
    target: Optional[str] = None    # hostname, or str(n) for grow
    reason: str = ""                # stable code, not measured numbers
    permanent: bool = False
    ttl_s: Optional[float] = None
    seq: int = 0
    role: Optional[str] = None      # convicted rank's (dp,pp,tp) label

    def log_line(self) -> str:
        """Deterministic JSON-lines form — no timestamps, no measured
        floats, so a seeded run's log repeats byte for byte. ``role``
        appears only under a hybrid spec (the serve controller's log
        shares this form)."""
        d = {"seq": self.seq, "action": self.action,
             "target": self.target, "reason": self.reason}
        if self.role is not None:
            d["role"] = self.role
        return json.dumps(d, sort_keys=True)


class AutoscaleEngine:
    """Turns step-time reports + host state into decisions. Lives in
    the DRIVER process (one per job) so its memory — straggler strikes,
    per-host eviction counts, cooldown stamps — spans elastic epochs.

    ``fetch_reports`` returns the freshest ``{rank: StepReport}`` (the
    driver reads the rendezvous KV scope directly); ``clock`` is
    injectable for deterministic tests.
    """

    def __init__(self, policy: AutoscalePolicy, min_np: int, max_np: int,
                 fetch_reports: Callable[[], Dict[int, StepReport]],
                 clock: Callable[[], float] = time.monotonic,
                 log_path: Optional[str] = None,
                 parallel=None):
        self.policy = policy
        if parallel is not None:
            raise NotImplementedError(
                "the role-aware autoscale engine (a hybrid ParallelSpec: "
                "replica-grouped scoring, respec) is not ported yet; it "
                f"comes with {_ROLES_SLICE} of the port")
        self.parallel = None
        self.min_np = policy.resolve_min_np(min_np)
        self.max_np = max_np
        self._fetch = fetch_reports
        self._clock = clock
        self._log_path = (log_path if log_path is not None
                          else runtime_env("AUTOSCALE_LOG")
                          or _config_fallback("autoscale_log") or None)
        self.decisions: List[Decision] = []
        self._seq = 0
        self._lock = threading.Lock()
        # Engine memory (spans epochs).
        self._strikes: Dict[str, int] = {}           # straggler strikes
        self._last_step: Dict[Tuple[str, int], int] = {}
        self._last_advance: Dict[str, float] = {}    # host -> clock()
        self._resync_base: Dict[Tuple[str, int], int] = {}
        self._evictions: Dict[str, int] = {}         # engine evicts/host
        self._assigned_ever: set = set()
        self._last_assignment: set = set()
        self._grown_for: set = set()  # adoption recorded, not yet assigned
        self._permanent: set = set()
        self._last_evict_t = -float("inf")
        self._last_grow_t = -float("inf")
        self._last_comm_fraction: Optional[float] = None

    # -- bookkeeping the driver feeds ---------------------------------------

    def observe_assignment(self, hosts) -> None:
        """Record the hosts of a starting epoch (high-water host set —
        distinguishes brand-new capacity from recovery churn; adopted
        hosts stop being grow candidates)."""
        with self._lock:
            self._assigned_ever.update(hosts)
            self._last_assignment = set(hosts)
            self._grown_for.difference_update(hosts)

    # -- decision plumbing ---------------------------------------------------

    def _record(self, decision: Decision) -> Decision:
        with self._lock:
            if decision.action != "keep":
                self._seq += 1
                decision.seq = self._seq
                # Only non-keep decisions are retained: a keep fires
                # every tick for the life of the driver, and nothing
                # ever reads keeps back (the counter below still counts
                # them) — retaining them would grow without bound.
                self.decisions.append(decision)
            if decision.action in ("evict", "shrink") and decision.target:
                # The host is leaving the world: its next usable
                # sighting is a RETURN (grow-candidate again).
                self._last_assignment.discard(decision.target)
                self._grown_for.discard(decision.target)
        _M_DECISIONS.labels(action=decision.action).inc()
        if decision.action != "keep":
            logger.warning("autoscale: decision #%d %s target=%s (%s)",
                           decision.seq, decision.action, decision.target,
                           decision.reason)
            if self._log_path:
                try:
                    with open(self._log_path, "a") as f:
                        f.write(decision.log_line() + "\n")
                except OSError:
                    pass  # the log is evidence, never a failure mode
        return decision

    def decision_log(self) -> List[str]:
        """The deterministic (non-keep) decision sequence."""
        with self._lock:
            return [d.log_line() for d in self.decisions
                    if d.action != "keep"]

    # -- the periodic tick: evict/shrink decisions ---------------------------

    def tick(self, usable_hosts: Dict[str, int],
             blacklist: Optional[Dict[str, Dict]] = None
             ) -> List[Decision]:
        """Evaluate evict/shrink triggers against the freshest reports.
        Returns the non-keep decisions (the driver applies each via
        ``HostManager.blacklist`` + an epoch interrupt); records one
        ``keep`` when nothing fires."""
        p = self.policy
        now = self._clock()
        decisions: List[Decision] = []
        reports = [r for r in self._fetch().values()
                   if r is not None and r.host in usable_hosts]

        cooldown_ok = now - self._last_evict_t >= p.evict_cooldown_s

        # At most ONE reshape decision per tick across every trigger
        # class (reshape, then re-measure): each
        # block below only runs while `decisions` is still empty.

        # Blacklist-strike escalation: HostManager's TTL/strike state is
        # the evidence; the engine turns "struck out" into a permanent
        # decision once.
        if p.max_blacklist_strikes > 0 and blacklist and not decisions:
            for host, entry in sorted(blacklist.items()):
                if host in self._permanent:
                    continue
                if entry.get("strikes", 0) >= p.max_blacklist_strikes \
                        and self._slots_after_evict(
                            usable_hosts, host) >= self.min_np:
                    self._permanent.add(host)
                    decisions.append(self._record(Decision(
                        action="evict", target=host,
                        reason="blacklist_strikes", permanent=True)))
                    break

        # Divergence-resync escalation. NOTE the attribution caveat:
        # the in-trace resync counter is bumped on EVERY rank when a
        # resync heals the world (integrity.record_divergence), so
        # equal deltas across ranks carry no attribution — only a host
        # whose delta STRICTLY exceeds every other host's can be named
        # the sick replica; an unattributable global signal stays a
        # keep (warned once per threshold crossing is the detector's
        # job, not ours).
        if p.max_divergence_resyncs > 0 and not decisions and cooldown_ok:
            deltas: Dict[str, int] = {}
            for r in reports:
                base = self._resync_base.setdefault((r.host, r.rank),
                                                    r.resyncs)
                d = r.resyncs - base
                deltas[r.host] = max(deltas.get(r.host, 0), d)
            over = sorted(h for h, d in deltas.items()
                          if d >= p.max_divergence_resyncs)
            if len(over) == 1 and all(
                    deltas[over[0]] > d for h, d in deltas.items()
                    if h != over[0]) \
                    and self._slots_after_evict(
                        usable_hosts, over[0]) >= self.min_np:
                host = over[0]
                self._purge_host(host)
                self._evictions[host] = self._evictions.get(host, 0) + 1
                self._last_evict_t = now
                decisions.append(self._record(Decision(
                    action="shrink", target=host,
                    reason="divergence_resyncs", ttl_s=p.evict_ttl_s)))

        # Step advancement tracking (feeds both straggler + stall). A
        # CHANGED step counter is advancement evidence — workers count
        # commits per process, so an elastic restart resets the counter
        # backwards; a stale report is the only thing that never moves.
        advanced: List[StepReport] = []
        for r in reports:
            key = (r.host, r.rank)
            prev = self._last_step.get(key)
            if prev is not None and r.step != prev:
                advanced.append(r)
                self._last_advance[r.host] = now
            if prev is None:
                # First sighting anchors the advancement baseline (and
                # the host's stall clock — silence is measured from
                # first contact, not from engine start).
                self._last_advance.setdefault(r.host, now)
            self._last_step[key] = r.step

        # Persistent stall: the host went silent while a peer advanced.
        # Same hysteresis as evictions: one shrink per tick, spaced by
        # the cooldown (a shared hiccup silencing several hosts at once
        # must reshape-and-re-measure, not collapse the world).
        if p.stall_timeout_s > 0 and advanced and not decisions \
                and cooldown_ok:
            for host in sorted(set(r.host for r in reports)):
                seen = self._last_advance.get(host)
                if seen is None or now - seen < p.stall_timeout_s:
                    continue
                if any(r.host != host for r in advanced) \
                        and self._slots_after_evict(
                            usable_hosts, host) >= self.min_np:
                    self._purge_host(host)
                    self._evictions[host] = \
                        self._evictions.get(host, 0) + 1
                    self._last_evict_t = now
                    decisions.append(self._record(Decision(
                        action="shrink", target=host, reason="stall",
                        ttl_s=p.evict_ttl_s)))
                    break

        # Straggler scoring: only ranks that ADVANCED this tick carry a
        # fresh measurement (a stale report can neither slow the median
        # nor flag its host), and only a quorum can name a straggler.
        flagged: set = set()
        if len(advanced) >= p.min_ranks:
            import statistics

            med = statistics.median(r.p50 for r in advanced)
            if med > 0:
                for r in advanced:
                    if r.p50 > p.straggler_ratio * med:
                        flagged.add(r.host)
            for host in set(r.host for r in advanced):
                if host in flagged:
                    self._strikes[host] = self._strikes.get(host, 0) + 1
                else:
                    self._strikes.pop(host, None)
        _M_STRAGGLERS.set(len(flagged))

        if cooldown_ok and not decisions:
            for host in sorted(self._strikes):
                if self._strikes[host] < p.straggler_patience:
                    continue
                if self._slots_after_evict(usable_hosts, host) \
                        < self.min_np:
                    logger.warning(
                        "autoscale: straggler %s NOT evicted — would "
                        "drop below min_np=%d", host, self.min_np)
                    continue
                count = self._evictions.get(host, 0) + 1
                self._evictions[host] = count
                permanent = (p.evict_permanent_after > 0
                             and count >= p.evict_permanent_after)
                if permanent:
                    self._permanent.add(host)
                self._purge_host(host)
                self._last_evict_t = now
                decisions.append(self._record(Decision(
                    action="evict", target=host, reason="straggler",
                    permanent=permanent,
                    ttl_s=None if permanent else p.evict_ttl_s)))
                break  # one eviction per tick — reshape, re-measure

        # Remember the freshest comm fraction for the grow gate.
        fracs = [r.comm_fraction for r in reports
                 if r.comm_fraction is not None]
        if fracs:
            self._last_comm_fraction = max(fracs)

        if not decisions:
            self._record(Decision(action="keep"))
        return decisions

    def _slots_after_evict(self, usable: Dict[str, int],
                           host: str) -> int:
        return sum(s for h, s in usable.items() if h != host)

    def _purge_host(self, host: str) -> None:
        """Forget a just-evicted host's report history: when it returns
        it must earn `patience` FRESH advancing flags again (stale
        pre-eviction reports cannot re-convict it)."""
        self._strikes.pop(host, None)
        self._last_advance.pop(host, None)
        for key in [k for k in self._last_step if k[0] == host]:
            self._last_step.pop(key, None)
        for key in [k for k in self._resync_base if k[0] == host]:
            self._resync_base.pop(key, None)

    # -- the epoch boundary: grow decisions / np cap -------------------------

    def pre_epoch(self, prev_np: Optional[int],
                  usable_hosts: Dict[str, int]) -> Optional[int]:
        """Called before assignments are computed for a new epoch.
        Returns an ``np`` cap (or None for no cap) and records a
        ``grow`` decision when the engine ADOPTS capacity beyond the
        previous epoch's world: an engine-evicted host whose exile
        expired, or a never-before-assigned host. Transiently lost
        hosts returning (recovery churn) pass through silently — the
        elastic layer owns those."""
        p = self.policy
        avail = sum(usable_hosts.values())
        with self._lock:
            # A grow candidate is capacity the ENGINE gets to decide
            # about: a host it evicted coming back after its exile, or
            # one never assigned before. Hosts that merely flapped away
            # and returned are recovery — the elastic layer owns those.
            candidates = sorted(
                h for h in usable_hosts
                if h not in self._grown_for
                and (h not in self._assigned_ever
                     or (h in self._evictions
                         and h not in self._permanent
                         and h not in self._last_assignment)))
        if prev_np is None or avail <= prev_np:
            return None
        if prev_np >= self.max_np:
            return self.max_np
        if not candidates:
            return None  # recovery churn, not an engine decision
        now = self._clock()
        gate_ok = now - self._last_grow_t >= p.grow_cooldown_s
        if gate_ok and p.grow_min_comm_fraction > 0:
            frac = self._last_comm_fraction
            gate_ok = frac is not None and \
                frac >= p.grow_min_comm_fraction
        if not gate_ok:
            # Hold: the policy refused the capacity — cap the epoch at
            # the previous world size instead of silently adopting it.
            return prev_np
        grow_to = min(avail, self.max_np)
        self._last_grow_t = now
        with self._lock:
            self._grown_for.update(candidates)
        self._record(Decision(action="grow",
                              target=str(grow_to - prev_np),
                              reason="capacity_available"))
        return None


def kv_report_fetcher(rdv_server) -> Callable[[], Dict[int, StepReport]]:
    """Driver-side reader over the in-process rendezvous KV: the
    freshest ``{rank: StepReport}`` published by the workers."""

    def fetch() -> Dict[int, StepReport]:
        out: Dict[int, StepReport] = {}
        for key, raw in rdv_server.scope_items(KV_SCOPE).items():
            if not key.startswith("steptime."):
                continue
            report = StepReport.from_json(raw)
            if report is not None:
                out[report.rank] = report
        return out

    return fetch
