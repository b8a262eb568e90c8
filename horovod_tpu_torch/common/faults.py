"""Deterministic fault injection and the shared recovery primitives of the
port — its copy of ``horovod_tpu/common/faults.py``.

* ``FaultPlan`` / ``FaultInjector``: a seedable plan of named injection
  sites, configured through ``HVD_TPU_FAULT_PLAN`` (JSON), so any entry
  point runs under chaos unchanged. Every injection is logged (and
  appended to ``HVD_TPU_FAULT_LOG`` as JSON lines) for replay checks.
* ``Backoff``: the shared retry policy (exponential, full jitter, an
  optional deadline) of the rendezvous client, the elastic reset loop
  and script host discovery.
* ``RecoveryStats``: process-wide counters (resets, restores, retries,
  blacklist events, preemptions, downtime), in the metrics registry and
  dumped at exit.

Injection sites (hit counters are per site and per process, 1-based):

======================  =================================================
site                    where it fires / what it does
======================  =================================================
``collective``          the eager engine's submit (one hit a collective
                        call) and ``DistributedOptimizer.synchronize``/
                        ``ZeroOptimizer.step`` (one hit a reduction
                        round): raises ``torch.distributed.
                        DistBackendError``, the type gloo and NCCL raise
                        for a dead peer, which ``elastic._is_comm_failure``
                        classifies
``collective_stall``    the eager engine, between a collective's issue and
                        its completion: sleeps ``delay_s`` (a rank hung
                        inside its collective)
``rendezvous``          ``RendezvousClient`` request: mode ``5xx``
                        (default, HTTP ``code``), ``drop`` (connection
                        error) or ``delay`` — one hit an HTTP attempt,
                        so the client's retry absorbs it
``discovery``           ``HostManager`` poll: mode ``flap`` (default, an
                        empty host set) or ``drop_host`` (``target``)
``crash``               ``State.commit()`` entry: ``os._exit(exit_code)``
                        before the snapshot
``preempt``             ``State.commit()`` entry: SIGTERM to self; the
                        latch is honored by this commit
``nonfinite``           ``integrity.chaos_poison`` (the eager allreduce's
                        input): one float lane set to NaN (mode ``inf``:
                        +Inf)
``diverge``             ``integrity.chaos_perturb``: ``scale`` noise on
                        one rank's slice of a rank-stacked tree
``checkpoint_corrupt``  ``CheckpointManager`` after a step's files are
                        committed: corrupt them (``bitflip`` default,
                        ``truncate``, ``sidecar``)
``straggler``           ``autoscale.StepPublisher.note`` (one hit a
                        ``State.commit()``): sleeps ``delay_s`` (a real
                        slow worker); ``scale`` inflates only the
                        reported step time
======================  =================================================

``moe_skew`` and ``replica_kill`` are known names (a plan that carries
them parses as in the JAX package) whose sites come with the slices
that hold them: MoE and the serve chaos family.

Plan JSON: ``{"seed": 42, "faults": [{"site": ..., "step": N |
"probability": p, "times": k, ...}]}`` (a bare list is accepted, seed 0).
``step`` fires on the Nth hit of the site; ``probability`` draws from a
per-spec ``random.Random`` seeded from (seed, spec index, site): the same
plan and program give the same injections. ``rank``/``host`` restrict a
spec to a worker (``HVD_TPU_PROC_ID`` / ``HVD_TPU_HOSTNAME``).

Without a plan every site is one global load and a None check.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from . import metrics as metrics_lib
from .config import runtime_env

logger = logging.getLogger("horovod_tpu_torch")

ENV_PLAN = "HVD_TPU_FAULT_PLAN"
ENV_LOG = "HVD_TPU_FAULT_LOG"

SITES = ("collective", "collective_stall", "rendezvous", "discovery",
         "crash", "preempt", "nonfinite", "diverge", "checkpoint_corrupt",
         "straggler", "moe_skew", "replica_kill")

_SPEC_FIELDS = ("site", "step", "probability", "times", "mode", "delay_s",
                "code", "exit_code", "message", "rank", "host", "target",
                "scale")


@dataclasses.dataclass
class FaultSpec:
    site: str
    step: Optional[int] = None      # fire on the Nth hit (1-based)
    probability: float = 0.0        # else: a Bernoulli draw a hit
    times: int = 1                  # most injections (<= 0: unlimited)
    mode: Optional[str] = None      # the site's action selector
    delay_s: float = 0.0
    code: int = 503                 # HTTP status of a rendezvous 5xx
    exit_code: int = 1              # of the crash site
    message: str = ""
    rank: Optional[int] = None      # only on HVD_TPU_PROC_ID
    host: Optional[str] = None      # only on HVD_TPU_HOSTNAME
    target: Optional[str] = None    # e.g. the host discovery drops
    scale: float = 0.0              # the diverge perturbation's size

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; known: {SITES}")
        if self.step is None and self.probability <= 0.0:
            raise ValueError(
                f"fault spec for site {self.site!r} needs 'step' or a "
                "positive 'probability'")


@dataclasses.dataclass
class FaultPlan:
    seed: int = 0
    faults: List[FaultSpec] = dataclasses.field(default_factory=list)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        data = json.loads(text)
        if isinstance(data, list):
            data = {"seed": 0, "faults": data}
        if not isinstance(data, dict):
            raise ValueError("fault plan must be a JSON object or list")
        specs = []
        for i, raw in enumerate(data.get("faults", [])):
            unknown = set(raw) - set(_SPEC_FIELDS)
            if unknown:
                # A typo must not silently disable the chaos it names.
                raise ValueError(
                    f"fault spec #{i} has unknown keys {sorted(unknown)}")
            specs.append(FaultSpec(**raw))
        return cls(seed=int(data.get("seed", 0)), faults=specs)


class FaultInjector:
    """Evaluates a :class:`FaultPlan` at the named sites,
    deterministically: each site keeps a hit counter, each spec a fired
    counter and (probability mode) its own seeded stream. Thread-safe."""

    def __init__(self, plan: FaultPlan, log_path: Optional[str] = None,
                 rank: Optional[str] = None, host: Optional[str] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.plan = plan
        self._clock = clock if clock is not None else time.time
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        self._fired: Dict[int, int] = {}
        self._rngs = [random.Random(f"{plan.seed}:{i}:{s.site}")
                      for i, s in enumerate(plan.faults)]
        self._log_path = log_path if log_path is not None \
            else runtime_env("FAULT_LOG") or None
        self._rank = rank if rank is not None else runtime_env("PROC_ID")
        self._host = host if host is not None else runtime_env("HOSTNAME")
        self.injections: List[dict] = []

    def _matches(self, i: int, spec: FaultSpec, hit: int) -> bool:
        if spec.rank is not None and str(spec.rank) != self._rank:
            return False
        if spec.host is not None and spec.host != self._host:
            return False
        if spec.times > 0 and self._fired.get(i, 0) >= spec.times:
            return False
        if spec.step is not None:
            return hit == spec.step or (
                spec.times != 1 and hit > spec.step
                and (spec.times <= 0 or hit - spec.step < spec.times))
        return self._rngs[i].random() < spec.probability

    def check(self, site: str) -> Optional[FaultSpec]:
        """Advance the site's hit counter; return the matching spec (and
        record the injection) or None."""
        with self._lock:
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
            for i, spec in enumerate(self.plan.faults):
                if spec.site != site:
                    continue
                if self._matches(i, spec, hit):
                    self._fired[i] = self._fired.get(i, 0) + 1
                    rec = {"seq": len(self.injections) + 1, "site": site,
                           "hit": hit, "spec": i, "mode": spec.mode,
                           "rank": self._rank, "host": self._host}
                    self.injections.append(rec)
                    self._record(rec, spec)
                    return spec
        return None

    def _record(self, rec: dict, spec: FaultSpec) -> None:
        stats.bump("injections")
        logger.warning(
            "chaos: injecting %s (hit %d, spec %d, mode=%s, rank=%s, "
            "host=%s)", rec["site"], rec["hit"], rec["spec"], spec.mode,
            rec["rank"], rec["host"])
        if self._log_path:
            try:
                with open(self._log_path, "a") as f:
                    f.write(json.dumps({**rec, "t": self._clock()}) + "\n")
            except OSError:     # the log is best-effort, never fatal
                pass

    def hit_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._hits)


# -- module-level installation ------------------------------------------------

_injector: Optional[FaultInjector] = None
_env_raw: Optional[str] = None


def install(plan: FaultPlan,
            log_path: Optional[str] = None) -> FaultInjector:
    global _injector
    _injector = FaultInjector(plan, log_path=log_path)
    logger.warning("chaos: fault plan installed (seed=%d, %d specs)",
                   plan.seed, len(plan.faults))
    return _injector


def uninstall() -> None:
    global _injector, _env_raw
    _injector = None
    _env_raw = None


def injector() -> Optional[FaultInjector]:
    return _injector


def active() -> bool:
    return _injector is not None


def refresh_from_env() -> Optional[FaultInjector]:
    """(Re)install from ``HVD_TPU_FAULT_PLAN`` when its raw value changed
    since the last parse (at import, ``init()`` and the driver's start);
    an unset or emptied variable uninstalls."""
    global _env_raw, _injector
    raw = runtime_env("FAULT_PLAN") or None
    if raw == _env_raw:
        return _injector
    _env_raw = raw
    if raw is None:
        _injector = None
        return None
    return install(FaultPlan.from_json(raw))


# -- site helpers ---------------------------------------------------------------

def _comm_error(message: str) -> Exception:
    """What gloo and NCCL raise for a torn connection."""
    import torch.distributed as dist

    return dist.DistBackendError(message)


def maybe_collective_fault() -> None:
    """A collective submit or reduction round: raise a comm failure."""
    inj = _injector
    if inj is None:
        return
    spec = inj.check("collective")
    if spec is not None:
        raise _comm_error(spec.message or
                          "injected: Connection closed by peer (chaos)")


def maybe_collective_stall() -> None:
    """The eager engine, after a collective's issue: hold it
    ``delay_s``."""
    inj = _injector
    if inj is None:
        return
    spec = inj.check("collective_stall")
    if spec is not None and spec.delay_s > 0:
        time.sleep(spec.delay_s)


def maybe_rendezvous_fault() -> None:
    """The rendezvous client, per HTTP attempt: 5xx / drop / delay."""
    inj = _injector
    if inj is None:
        return
    spec = inj.check("rendezvous")
    if spec is None:
        return
    mode = spec.mode or "5xx"
    if mode == "delay":
        time.sleep(spec.delay_s)
        return
    import urllib.error

    if mode == "drop":
        raise urllib.error.URLError(
            ConnectionResetError(spec.message or "injected: connection "
                                 "reset (chaos)"))
    raise urllib.error.HTTPError(
        "chaos://injected", spec.code,
        spec.message or "injected server error (chaos)", None, None)


def maybe_discovery_flap(hosts: Dict[str, int]) -> Dict[str, int]:
    """A host-discovery poll: flap the reported host set."""
    inj = _injector
    if inj is None:
        return hosts
    spec = inj.check("discovery")
    if spec is None:
        return hosts
    if (spec.mode or "flap") == "drop_host":
        return {h: s for h, s in hosts.items() if h != spec.target}
    return {}


def maybe_worker_fault() -> None:
    """``State.commit()`` entry: crash hard, or SIGTERM this process."""
    inj = _injector
    if inj is None:
        return
    spec = inj.check("crash")
    if spec is not None:
        logger.warning("chaos: hard worker crash (os._exit(%d))",
                       spec.exit_code)
        logging.shutdown()
        os._exit(spec.exit_code)
    spec = inj.check("preempt")
    if spec is not None:
        import signal

        os.kill(os.getpid(), signal.SIGTERM)


def maybe_nonfinite() -> Optional[FaultSpec]:
    """``integrity.chaos_poison``'s site."""
    inj = _injector
    return None if inj is None else inj.check("nonfinite")


def maybe_diverge() -> Optional[FaultSpec]:
    """``integrity.chaos_perturb``'s site."""
    inj = _injector
    return None if inj is None else inj.check("diverge")


def maybe_straggler() -> Optional[FaultSpec]:
    """``autoscale.StepPublisher.note``'s site, one hit a
    ``State.commit()``: ``delay_s`` sleeps the worker for real (an honest
    slow worker the autoscale engine must find and evict); ``scale``
    only inflates the reported step time."""
    inj = _injector
    return None if inj is None else inj.check("straggler")


def maybe_checkpoint_corrupt() -> Optional[FaultSpec]:
    """``CheckpointManager``'s site, one hit a committed step."""
    inj = _injector
    return None if inj is None else inj.check("checkpoint_corrupt")


# -- the shared retry policy ------------------------------------------------------

class Backoff:
    """Exponential backoff with FULL jitter and an optional deadline:
    the delay of attempt n is ``uniform(0, min(cap_s, base_s *
    factor**n))``. Deterministic under an injected ``rng``
    (``random.Random(seed)``); ``clock`` and ``sleep_fn`` are injectable
    for tests."""

    def __init__(self, base_s: float = 0.1, factor: float = 2.0,
                 cap_s: float = 5.0, deadline_s: Optional[float] = None,
                 rng=None, clock: Callable[[], float] = time.monotonic,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.base_s = base_s
        self.factor = factor
        self.cap_s = cap_s
        self.deadline_s = deadline_s
        self._rng = rng if rng is not None else random
        self._clock = clock
        self._sleep = sleep_fn
        self._t0 = clock()
        self.attempts = 0

    @classmethod
    def from_env(cls, prefix: str, base_s: float, cap_s: float,
                 deadline_s: Optional[float] = None, **kwargs) -> "Backoff":
        """Knobs ``<prefix>_BASE_S`` / ``<prefix>_MAX_S`` /
        ``<prefix>_DEADLINE_S`` (unset or non-positive deadline: none)."""

        def _f(name: str, default: Optional[float]) -> Optional[float]:
            raw = os.environ.get(prefix + name)
            if raw is None:
                return default
            try:
                return float(raw)
            except ValueError:
                return default

        deadline = _f("_DEADLINE_S", deadline_s)
        if deadline is not None and deadline <= 0:
            deadline = None
        return cls(base_s=_f("_BASE_S", base_s), cap_s=_f("_MAX_S", cap_s),
                   deadline_s=deadline, **kwargs)

    def reset(self) -> None:
        self.attempts = 0
        self._t0 = self._clock()

    def remaining(self) -> Optional[float]:
        if self.deadline_s is None:
            return None
        return self.deadline_s - (self._clock() - self._t0)

    def next_delay(self) -> float:
        ceiling = min(self.cap_s, self.base_s * (self.factor **
                                                 self.attempts))
        self.attempts += 1
        return self._rng.uniform(0.0, ceiling)

    def sleep(self) -> bool:
        """Sleep the next jittered delay. Returns False (without sleeping
        past it) once the deadline is spent: stop retrying."""
        delay = self.next_delay()
        rem = self.remaining()
        if rem is not None:
            if rem <= 0:
                return False
            delay = min(delay, rem)
        self._sleep(delay)
        return self.remaining() is None or self.remaining() > 0


# -- recovery bookkeeping ----------------------------------------------------------

class RecoveryStats:
    """Process-wide recovery counters, mirrored into the metrics registry
    (``hvd_tpu_recovery_total{counter=}``, every known counter seeded at 0
    so absence differs from silence), into the timeline as
    ``RECOVERY:<counter>`` instants when it is on, and dumped at process
    exit (log, and ``HVD_TPU_RECOVERY_STATS_FILE``) once any is
    nonzero."""

    COUNTERS = ("resets", "restores", "retries", "rendezvous_retries",
                "discovery_retries", "blacklist_events",
                "blacklist_recoveries", "preemptions", "injections",
                "divergence_resyncs", "checkpoint_corruptions")

    _METRIC = metrics_lib.counter(
        "hvd_tpu_recovery_total",
        "recovery events (RecoveryStats) by counter name",
        labels=("counter",))
    _METRIC_DOWNTIME = metrics_lib.gauge(
        "hvd_tpu_recovery_downtime_seconds",
        "accumulated recovery downtime")
    for _c in COUNTERS:
        _METRIC.labels(counter=_c)
    del _c

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self.downtime_seconds = 0.0
        self._exit_hook_registered = False

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n
            if name.endswith("_retries"):
                # "retries" aggregates every retry family.
                self._counts["retries"] = self._counts.get("retries", 0) + n
        self._METRIC.labels(counter=name).inc(n)
        if name.endswith("_retries"):
            self._METRIC.labels(counter="retries").inc(n)
        self._register_exit_hook()
        self._emit_timeline(name)

    def add_downtime(self, seconds: float) -> None:
        if seconds <= 0:
            return
        with self._lock:
            self.downtime_seconds += seconds
            self._METRIC_DOWNTIME.set(self.downtime_seconds)
        self._register_exit_hook()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {k: self._counts.get(k, 0)
                                   for k in self.COUNTERS}
            for k, v in self._counts.items():
                out.setdefault(k, v)
            out["downtime_seconds"] = round(self.downtime_seconds, 3)
            return out

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self.downtime_seconds = 0.0

    def _emit_timeline(self, name: str) -> None:
        # Observability must never break recovery.
        try:
            from . import basics

            if basics.is_initialized():
                basics.context().timeline.instant(f"RECOVERY:{name}")
        except Exception:  # noqa: BLE001
            pass

    def _register_exit_hook(self) -> None:
        if self._exit_hook_registered:
            return
        self._exit_hook_registered = True
        # The process's one ordered teardown (common/shutdown.py): the
        # counter dump runs last, after the flight recorder finalized
        # and the metrics dump drained.
        from . import shutdown as shutdown_lib

        shutdown_lib.register("recovery_stats", self._dump_at_exit,
                              shutdown_lib.RECOVERY_STATS_PRIORITY)

    def _dump_at_exit(self) -> None:
        snap = self.snapshot()
        if not any(v for v in snap.values()):
            return
        logger.warning("recovery stats at exit: %s", json.dumps(snap))
        path = runtime_env("RECOVERY_STATS_FILE")
        if path:
            try:
                with open(path, "w") as f:
                    json.dump(snap, f)
            except OSError:
                pass


stats = RecoveryStats()


def recovery_stats() -> Dict[str, Any]:
    """Snapshot of the process-wide recovery counters."""
    return stats.snapshot()


# A plan exported by the launcher before this process imported us.
refresh_from_env()
