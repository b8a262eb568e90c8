"""Recovery bookkeeping of the port: ``RecoveryStats`` and its process-wide
instance ``stats``, the port's copy of that part of
``horovod_tpu/common/faults.py``.

The integrity guard bumps ``divergence_resyncs`` and the checkpoint layer
``checkpoint_corruptions``; the elastic layer, which bumps the others,
comes with a later slice, as do the fault plan, its injector and its
injection sites.
"""

from __future__ import annotations

import atexit
import json
import logging
import threading
from typing import Any, Dict

from . import metrics as metrics_lib
from .config import runtime_env

logger = logging.getLogger("horovod_tpu_torch")


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
        if not self._exit_hook_registered:
            self._exit_hook_registered = True
            atexit.register(self._dump_at_exit)

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
