"""Flight recorder: the ring of recent events a post-mortem reads.

The port's copy of the event ring of ``horovod_tpu/common/flightrec.py``
as the serve engine uses it: every decode round is bracketed with
``record_submit`` / ``annotate`` / ``record_complete`` (op ``serve``),
so the ring names the decode batch a hung replica never completed; the
eager engine records every collective's submit. The black-box dump, its
triggers (the elastic loop's peer-failure dump, the driver's SIGUSR2
fan-out) and the rendezvous push come with the telemetry and control
slice of the port, as does ``hvd.flight_recorder``.

Knobs: ``HVD_TPU_FLIGHTREC`` (default on), ``HVD_TPU_FLIGHTREC_SIZE``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from . import metrics as metrics_lib
from .config import runtime_env

EVENT_KEYS = ("seq", "op", "name", "step", "bytes", "wire",
              "t_submit", "t_complete", "outcome", "trace")

_M_EVENTS = metrics_lib.counter(
    "hvd_tpu_flightrec_events_total",
    "collective events recorded into the flight-recorder ring")


def _truthy(raw: Optional[str], default: bool) -> bool:
    if raw is None:
        return default
    return raw.strip().lower() not in ("0", "false", "no", "off", "")


class _Event:
    __slots__ = EVENT_KEYS

    def __init__(self, seq: int, op: str, name: str, step: int,
                 t_submit: float):
        self.seq = seq
        self.op = op
        self.name = name
        self.step = step
        self.bytes = 0
        self.wire = ""
        self.t_submit = t_submit
        self.t_complete: Optional[float] = None
        self.outcome = "pending"
        self.trace = ""

    def to_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in EVENT_KEYS}


class FlightRecorder:
    """Fixed-size ring of events; one lock held only for the list and
    dict writes of a record."""

    def __init__(self, size: int = 256, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = _truthy(runtime_env("FLIGHTREC"), True)
        self.enabled = bool(enabled)
        self.size = max(8, int(size))
        self._lock = threading.Lock()
        self._ring: List[Optional[_Event]] = [None] * self.size
        self._by_name: Dict[str, _Event] = {}   # pending events only
        self._seq = 0
        self.step = 0

    def record_submit(self, name: str, op: str) -> int:
        """Record a submitted event; returns its sequence number."""
        if not self.enabled:
            return -1
        now = time.monotonic()
        with self._lock:
            self._seq += 1
            ev = _Event(self._seq, op, name, self.step, now)
            self._ring[(self._seq - 1) % self.size] = ev
            self._by_name[name] = ev
        _M_EVENTS.inc()
        return ev.seq

    def annotate(self, name: str, nbytes: Optional[int] = None,
                 wire: Optional[str] = None,
                 trace: Optional[str] = None) -> None:
        """Attach payload facts to the in-flight event; ``trace`` is the
        serve plane's request-id CSV."""
        if not self.enabled:
            return
        with self._lock:
            ev = self._by_name.get(name)
            if ev is None:
                return
            if nbytes is not None:
                ev.bytes = int(nbytes)
            if wire is not None:
                ev.wire = str(wire)
            if trace is not None:
                ev.trace = str(trace)

    def record_complete(self, name: str, outcome: str = "ok") -> None:
        """Complete the in-flight event (first completion wins)."""
        if not self.enabled:
            return
        now = time.monotonic()
        with self._lock:
            ev = self._by_name.pop(name, None)
            if ev is None or ev.t_complete is not None:
                return
            ev.t_complete = now
            ev.outcome = outcome

    def events(self) -> List[Dict[str, Any]]:
        """Ring contents, oldest first."""
        with self._lock:
            seq = self._seq
            ring = list(self._ring)
        if seq <= self.size:
            ordered = ring[:seq]
        else:
            head = seq % self.size
            ordered = ring[head:] + ring[:head]
        return [ev.to_dict() for ev in ordered if ev is not None]


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def recorder() -> FlightRecorder:
    """The process-wide recorder (env-configured on first use)."""
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                try:
                    size = int(runtime_env("FLIGHTREC_SIZE", "256"))
                except ValueError:
                    size = 256
                _recorder = FlightRecorder(size=size)
    return _recorder
