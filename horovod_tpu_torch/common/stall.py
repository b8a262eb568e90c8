"""Stall inspector — detects collectives stuck past a threshold; the
port's copy of ``horovod_tpu/common/stall.py``.

Reference Horovod's coordinator warns when some ranks have submitted a
tensor and others have not for longer than
``HOROVOD_STALL_CHECK_TIME_SECONDS``, and can shut the job down after
``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS``. Here the inspector tracks the
submit→complete age of every named eager collective (and of a joined
process's wait for its peers): (a) it warns past ``check_time``
(``hvd_tpu_stall_warnings_total``, the flight ring's event marked
``stalled``), (b) it raises :class:`StallError` past ``shutdown_time``
when polled — a :class:`StallTimeoutError` under
``HVD_TPU_STALL_FATAL=raise``, which the elastic loop takes as a comm
failure. A daemon watchdog thread polls; a fatal verdict there is
latched in ``fatal`` and raised by the next submit.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

from . import lockdep
from . import metrics as metrics_lib
from .exceptions import StallError, StallTimeoutError

logger = logging.getLogger("horovod_tpu_torch")

# In-flight depth and stall events on the same scrape as everything
# else. Process-wide: the world engine and the process-set engines share
# one inspector a context, and a pod-level scrape asks "is anything
# stuck", not which engine.
_M_INFLIGHT = metrics_lib.gauge(
    "hvd_tpu_stall_inflight",
    "collectives submitted but not yet completed")
_M_WARNINGS = metrics_lib.counter(
    "hvd_tpu_stall_warnings_total",
    "collectives that aged past the stall check threshold")
_M_FATAL = metrics_lib.counter(
    "hvd_tpu_stall_fatal_total",
    "stalls past the shutdown threshold (StallError raised/latched)")


class StallInspector:
    def __init__(self, check_time_seconds: float = 60.0,
                 shutdown_time_seconds: float = 0.0,
                 disabled: bool = False,
                 fatal_mode: Optional[str] = None):
        self.check_time = check_time_seconds
        self.shutdown_time = shutdown_time_seconds
        self.disabled = disabled
        # HVD_TPU_STALL_FATAL=raise: the fatal path raises a typed
        # StallTimeoutError, which — as a HorovodInternalError
        # subclass — the elastic retry loop classifies as a comm
        # failure, so a hung collective aborts into an elastic reset
        # instead of wedging the run. The default StallError escapes
        # the retry loop. Warning counters are identical in both modes.
        # Unknown values raise: a typo'd knob must not silently disable
        # the escalation it was meant to configure.
        self.fatal_mode = (fatal_mode or "").strip().lower() or None
        if self.fatal_mode not in (None, "raise"):
            raise ValueError(
                f"unknown HVD_TPU_STALL_FATAL mode {fatal_mode!r}; "
                "known: 'raise' (or unset for the historical latched "
                "StallError)")
        self.fatal: Optional[StallError] = None
        self._inflight: Dict[str, float] = {}
        self._warned: set = set()
        self._lock = lockdep.lock("stall.inflight")
        self._watchdog: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def record_submit(self, name: str) -> None:
        if self.disabled:
            return
        self.raise_if_fatal()
        with self._lock:
            self._inflight[name] = time.monotonic()
            _M_INFLIGHT.set(len(self._inflight))

    def record_complete(self, name: str) -> None:
        if self.disabled:
            return
        with self._lock:
            self._inflight.pop(name, None)
            self._warned.discard(name)
            _M_INFLIGHT.set(len(self._inflight))

    def check(self) -> bool:
        """Poll for stalls; returns True if any stalled tensor was found.
        Raises StallError past the shutdown threshold."""
        if self.disabled:
            return False
        self.raise_if_fatal()
        now = time.monotonic()
        stalled = False
        with self._lock:
            items = list(self._inflight.items())
        for name, t0 in items:
            age = now - t0
            if self.shutdown_time > 0 and age > self.shutdown_time:
                _M_FATAL.inc()
                exc_type = (StallTimeoutError
                            if self.fatal_mode == "raise" else StallError)
                exc = exc_type(
                    f"collective {name} stalled for {age:.0f}s "
                    f"(> shutdown threshold {self.shutdown_time:.0f}s)")
                # Black box at latch time: the hung collective is STILL
                # pending in the flight ring here — the moment the
                # post-mortem needs captured. Dumping from the watchdog
                # thread is deliberate: the main thread may be wedged
                # inside the very collective.
                from . import flightrec as flightrec_lib

                flightrec_lib.recorder().dump(
                    "stall_timeout",
                    reason=f"{exc_type.__name__}: {exc}")
                raise exc
            if age > self.check_time:
                stalled = True
                if name not in self._warned:
                    _M_WARNINGS.inc()
                    logger.warning(
                        "One or more collectives submitted but not "
                        "completed for >%.0fs: %s", self.check_time, name)
                    from . import flightrec as flightrec_lib

                    flightrec_lib.recorder().mark_stalled(name)
                    with self._lock:
                        self._warned.add(name)
        return stalled

    def inflight(self):
        with self._lock:
            return dict(self._inflight)

    # -- watchdog ----------------------------------------------------------
    #
    # A daemon thread polls. A tripped shutdown threshold cannot raise
    # into the main thread, so the error is latched in ``fatal`` and
    # re-raised by the next collective submit (or any explicit check()).

    def raise_if_fatal(self) -> None:
        if self.fatal is not None:
            raise self.fatal

    def start_watchdog(self, poll_interval: Optional[float] = None) -> None:
        if self.disabled or self._watchdog is not None:
            return
        interval = poll_interval if poll_interval is not None else \
            min(max(self.check_time / 4.0, 0.05), 10.0)
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.wait(interval):
                try:
                    self.check()
                except StallError as e:
                    self.fatal = e
                    logger.critical(
                        "stall watchdog: %s — failing subsequent "
                        "collectives", e)
                    return

        self._watchdog = threading.Thread(
            target=_loop, daemon=True, name="hvd-tpu-stall-watchdog")
        self._watchdog.start()

    def stop_watchdog(self) -> None:
        self._stop.set()
        t, self._watchdog = self._watchdog, None
        if t is not None and t.is_alive():
            t.join(timeout=2.0)
