"""Runtime lock-order watchdog of the port — its copy of
``horovod_tpu/common/lockdep.py``.

A signal handler that takes a lock the interrupted thread holds
deadlocks the process, and only a live run shows it. This module records
the runtime shape of such bugs: any two locks ever acquired in both
orders across threads, from the acquisition DAG the threaded subsystems
build while they run.

The telemetry subsystems (metrics, flightrec, podmon, stall) create
their locks through :func:`lock` with a stable name. With
``HVD_TPU_LOCKDEP`` unset (the default), :func:`lock` returns a plain
``threading.Lock``: nothing recorded, no overhead. With
``HVD_TPU_LOCKDEP=1`` each acquisition appends held→acquired edges to a
process-wide graph and checks for a cycle; a found cycle is logged and
kept for :func:`cycles`. ``HVD_TPU_LOCKDEP=raise`` also raises
:class:`LockCycleError` at the acquisition that closed the cycle.

The graph records ORDER (lock-name pairs), not instances: two distinct
``metrics.family`` locks never nest, so one node per name keeps the
graph small and the verdict readable.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Tuple

from .config import runtime_env

logger = logging.getLogger("horovod_tpu_torch")


class LockCycleError(RuntimeError):
    """A lock-acquisition cycle was closed (HVD_TPU_LOCKDEP=raise)."""


class _Watchdog:
    """Process-wide acquisition graph. Internal synchronization uses a
    bare ``threading.Lock`` — the watchdog must not watch itself."""

    def __init__(self, mode: str = "record"):
        self.mode = mode
        self._lock = threading.Lock()
        # edge a -> b: first (thread, b-name) that acquired b under a.
        self._edges: Dict[str, Dict[str, str]] = {}
        self._cycles: List[Tuple[str, ...]] = []
        self._tls = threading.local()

    # -- per-acquisition hooks (called with the tracked lock HELD) ----------

    def note_acquire(self, name: str) -> None:
        held: List[str] = getattr(self._tls, "held", None) or []
        self._tls.held = held
        fresh = False
        with self._lock:
            for h in held:
                if h != name:
                    tgt = self._edges.setdefault(h, {})
                    if name not in tgt:
                        tgt[name] = threading.current_thread().name
                        fresh = True
        held.append(name)
        if fresh:
            cycle = self._find_cycle()
            if cycle is not None:
                with self._lock:
                    if cycle not in self._cycles:
                        self._cycles.append(cycle)
                msg = ("lockdep: acquisition cycle "
                       + " -> ".join([*cycle, cycle[0]])
                       + f" closed by thread "
                       f"{threading.current_thread().name!r} acquiring "
                       f"{name!r}")
                logger.error(msg)
                if self.mode == "raise":
                    raise LockCycleError(msg)

    def note_release(self, name: str) -> None:
        held: Optional[List[str]] = getattr(self._tls, "held", None)
        if not held:
            return
        # Remove the LAST occurrence: two same-named locks (two
        # instances of one class) may legitimately be held at once.
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    # -- graph queries ------------------------------------------------------

    def edges(self) -> Dict[str, Tuple[str, ...]]:
        with self._lock:
            return {a: tuple(sorted(bs)) for a, bs in self._edges.items()}

    def cycles(self) -> List[Tuple[str, ...]]:
        with self._lock:
            return list(self._cycles)

    def _find_cycle(self) -> Optional[Tuple[str, ...]]:
        with self._lock:
            graph = {a: list(bs) for a, bs in self._edges.items()}
        WHITE, GRAY, BLACK = 0, 1, 2
        color: Dict[str, int] = {}
        stack: List[str] = []

        def visit(node: str) -> Optional[Tuple[str, ...]]:
            color[node] = GRAY
            stack.append(node)
            for nxt in graph.get(node, ()):
                c = color.get(nxt, WHITE)
                if c == GRAY:
                    i = stack.index(nxt)
                    cyc = tuple(stack[i:])
                    k = cyc.index(min(cyc))
                    return cyc[k:] + cyc[:k]
                if c == WHITE:
                    found = visit(nxt)
                    if found is not None:
                        return found
            stack.pop()
            color[node] = BLACK
            return None

        for node in sorted(graph):
            if color.get(node, WHITE) == WHITE:
                found = visit(node)
                if found is not None:
                    return found
        return None


class TrackedLock:
    """``threading.Lock`` facade that reports acquisitions to the
    watchdog. Only constructed when lockdep is enabled — disabled
    callers get the plain lock and pay nothing."""

    __slots__ = ("_name", "_lock", "_dog")

    def __init__(self, name: str, dog: _Watchdog):
        self._name = name
        self._lock = threading.Lock()
        self._dog = dog

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            try:
                self._dog.note_acquire(self._name)
            except LockCycleError:
                # raise-mode verdict: hand the lock back before
                # propagating so the failing test doesn't wedge every
                # other thread behind a never-released lock.
                self._dog.note_release(self._name)
                self._lock.release()
                raise
        return got

    def release(self) -> None:
        self._lock.release()
        self._dog.note_release(self._name)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


_state_lock = threading.Lock()
_watchdog: Optional[_Watchdog] = None
_resolved = False


def _resolve() -> Optional[_Watchdog]:
    """Env-resolved watchdog, decided ONCE per process (locks are
    created at subsystem construction; flipping mid-run would split
    the graph)."""
    global _watchdog, _resolved
    if _resolved:
        return _watchdog
    with _state_lock:
        if not _resolved:
            raw = (runtime_env("LOCKDEP") or "").strip().lower()
            if raw in ("", "0", "false", "no", "off"):
                _watchdog = None
            else:
                _watchdog = _Watchdog(
                    mode="raise" if raw == "raise" else "record")
            _resolved = True
    return _watchdog


def lock(name: str):
    """A lock for subsystem ``name`` (dotted, stable —
    ``"metrics.family"``, ``"flightrec.ring"``). Plain
    ``threading.Lock`` when lockdep is off; a :class:`TrackedLock`
    feeding the acquisition graph when on."""
    dog = _resolve()
    if dog is None:
        return threading.Lock()
    return TrackedLock(name, dog)


def enabled() -> bool:
    return _resolve() is not None


def edges() -> Dict[str, Tuple[str, ...]]:
    dog = _resolve()
    return dog.edges() if dog is not None else {}


def cycles() -> List[Tuple[str, ...]]:
    dog = _resolve()
    return dog.cycles() if dog is not None else []


def install(mode: str = "record") -> None:
    """Force-enable for tests (bypasses the env knob). Locks created
    BEFORE install() stay plain — construct subsystems after."""
    global _watchdog, _resolved
    with _state_lock:
        _watchdog = _Watchdog(mode=mode)
        _resolved = True


def _reset_for_tests() -> None:
    global _watchdog, _resolved
    with _state_lock:
        _watchdog = None
        _resolved = False
