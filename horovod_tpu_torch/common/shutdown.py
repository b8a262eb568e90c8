"""One ordered process-shutdown sequence for every teardown hook — the
port's copy of ``horovod_tpu/common/shutdown.py``.

Subsystems register named callbacks with an explicit priority, and ONE
``atexit`` hook runs them in priority order:

1. flight recorder finalize (priority 10): capture the in-flight ring
   and any signal-requested black box FIRST, while the engine and the
   stall state are still alive;
2. context shutdown (priority 20): stops the stall watchdog, drains the
   metrics dump (final snapshot line), stops the HTTP endpoints and
   destroys the process group;
3. RecoveryStats dump (priority 30): the counters summarize the whole
   run, including anything the two steps above bumped.

Independent ``atexit`` hooks would run in reverse registration order,
an accident of which subsystem was touched first. Registration is
idempotent per name (last registration wins) and safe from any thread;
callbacks never raise out of the sequence.
"""

from __future__ import annotations

import atexit
import logging
import threading
from typing import Callable, Dict, Tuple

logger = logging.getLogger("horovod_tpu_torch")

# Canonical priorities (documented above; used by the registrants).
FLIGHTREC_PRIORITY = 10
CONTEXT_PRIORITY = 20
RECOVERY_STATS_PRIORITY = 30

_lock = threading.Lock()
_callbacks: Dict[str, Tuple[int, Callable[[], None]]] = {}
_hook_registered = False
_ran = False


def register(name: str, fn: Callable[[], None],
             priority: int = 50) -> None:
    """Register (or replace) a named shutdown callback. Lower priority
    runs first. The single underlying ``atexit`` hook is installed on
    the first registration."""
    global _hook_registered
    with _lock:
        _callbacks[name] = (priority, fn)
        if not _hook_registered:
            _hook_registered = True
            atexit.register(run)


def unregister(name: str) -> None:
    with _lock:
        _callbacks.pop(name, None)


def run() -> None:
    """Run the shutdown sequence once (idempotent; re-entrant calls —
    e.g. an explicit call followed by the atexit firing — are no-ops).
    Each callback is isolated: a failing one logs and the sequence
    continues."""
    global _ran
    with _lock:
        if _ran:
            return
        _ran = True
        items = sorted(_callbacks.items(), key=lambda kv: kv[1][0])
    for name, (_, fn) in items:
        try:
            fn()
        except Exception:  # noqa: BLE001 — teardown must finish
            logger.exception("shutdown: %s callback failed", name)


def _reset_for_tests() -> None:
    """Forget registrations and the ran-latch (the atexit hook stays
    installed; with no callbacks it is a no-op)."""
    global _ran
    with _lock:
        _callbacks.clear()
        _ran = False
