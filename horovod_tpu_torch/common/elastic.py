"""Elastic training of the port: the retry loop and state
commit/restore — its copy of ``horovod_tpu/common/elastic.py``.

A reset tears the whole runtime down (``basics.shutdown()``) and
initializes it again, against a fresh store prefix, and user code
re-enters the train function with the restored state. Under a launch by
the elastic driver (``HVD_TPU_RENDEZVOUS`` set) a peer failure is not
retried in-process: the world's membership changed, so the worker exits
``PEER_FAILURE_EXIT_CODE`` and the driver starts the next epoch, whose
workers resume from their persisted state.

What a comm failure is (:func:`_is_comm_failure`): what torch raises
when a peer dies — ``torch.distributed.DistError`` and its subclasses
(``DistBackendError`` for gloo's "Connection closed by peer" or a timed
out collective, ``DistStoreError``, ``DistNetworkError``) and a gloo
``RuntimeError`` carrying a comm marker — and the port's own
:class:`~.exceptions.HorovodInternalError`. A user's ``ValueError`` or
``ConnectionError`` surfaces instead of being retried.

A live ``DistributedOptimizer`` or ``ZeroOptimizer`` holds the old
world's axis handles: after an in-process reset ``TorchState.on_reset``
rebinds them to the new world (``optim.rebind``).
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from typing import Any, Callable, Dict, Optional

from . import faults as faults_lib
from .config import runtime_env
from .exceptions import HorovodInternalError, HostsUpdatedInterrupt

logger = logging.getLogger("horovod_tpu_torch")


# -- preemption ----------------------------------------------------------------
#
# A preemption arrives as SIGTERM with a short grace window. The handler
# only latches a flag; the next ``state.commit()`` honors it: the final
# snapshot, the registered persistence callbacks, then a clean
# HOSTS_UPDATED_EXIT_CODE exit so the driver reschedules the work.

_preempt_event = threading.Event()
_preempt_lock = threading.Lock()
_preempt_installed = False
_preempt_callbacks: list = []


def _on_preempt_signal(signum, frame) -> None:
    # Only latch: logging here could deadlock on a lock the interrupted
    # frame holds.
    _preempt_event.set()


def install_preemption_handler(signals=None) -> bool:
    """Install the SIGTERM latch (idempotent). Returns False off the main
    thread (the signal module's rule)."""
    global _preempt_installed
    import signal as signal_mod

    with _preempt_lock:
        if _preempt_installed:
            return True
        sigs = tuple(signals) if signals else (signal_mod.SIGTERM,)
        try:
            for s in sigs:
                signal_mod.signal(s, _on_preempt_signal)
        except ValueError:          # not the main thread
            return False
        _preempt_installed = True
        return True


def preemption_requested() -> bool:
    """True once a preemption signal has been latched."""
    return _preempt_event.is_set()


def on_preemption(callback: Callable[["State"], None]) -> None:
    """Register a final-persistence callback, run with the state after
    its last ``save()`` and before the clean preemption exit (e.g. a
    closure over ``checkpoint.save_state``)."""
    _preempt_callbacks.append(callback)


def _reset_preemption_for_tests() -> None:
    global _preempt_installed
    import signal as signal_mod

    with _preempt_lock:
        _preempt_event.clear()
        _preempt_callbacks.clear()
        if _preempt_installed:
            try:
                signal_mod.signal(signal_mod.SIGTERM, signal_mod.SIG_DFL)
            except ValueError:
                pass
            _preempt_installed = False


class State:
    """The base state: ``commit`` = the worker fault site, ``save``, the
    preemption latch, the host-update check."""

    def __init__(self, **kwargs):
        self._host_messages: list = []
        self._reset_callbacks: list = []
        self._saved: Optional[Dict[str, Any]] = None

    def register_reset_callbacks(self, callbacks) -> None:
        self._reset_callbacks.extend(callbacks)

    def on_reset(self) -> None:
        for cb in self._reset_callbacks:
            cb()

    def commit(self) -> None:
        """Snapshot, honor a latched preemption, check for host updates.
        The chaos worker faults fire first: a crash here loses the
        uncommitted progress, and an injected preemption latches in time
        for this commit. One commit is one training step to the
        telemetry: the autoscale publisher measures it (a None check
        unless the elastic driver runs autoscaling) and the flight
        recorder stamps the step onto its next events."""
        faults_lib.maybe_worker_fault()
        from . import autoscale as autoscale_lib
        from . import flightrec as flightrec_lib

        autoscale_lib.note_step()
        flightrec_lib.note_commit()
        self.save()
        self._handle_preemption()
        self.check_host_updates()

    def _handle_preemption(self) -> None:
        if not _preempt_event.is_set():
            return
        import sys

        faults_lib.stats.bump("preemptions")
        logger.warning("preemption signal latched; running final "
                       "persistence callbacks")
        for cb in list(_preempt_callbacks):
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — the committed snapshot
                logger.exception(  # stands; persistence is best-effort
                    "preemption persistence callback failed")
        logger.warning(
            "elastic: preempted — committed state saved; exiting %d for "
            "driver reschedule", HOSTS_UPDATED_EXIT_CODE)
        sys.exit(HOSTS_UPDATED_EXIT_CODE)

    def save(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError

    def check_host_updates(self) -> None:
        """Raise :class:`HostsUpdatedInterrupt` when the driver reported
        a changed host set."""
        from . import basics

        if not basics.is_initialized():
            return
        notifier = basics.context().host_update_notifier
        if notifier is not None and notifier():
            raise HostsUpdatedInterrupt()


class ObjectState(State):
    """A state of picklable attributes: ``save`` deep-copies them,
    ``sync`` broadcasts rank 0's."""

    def __init__(self, **kwargs):
        super().__init__()
        self._attrs = dict(kwargs)
        for k, v in kwargs.items():
            object.__setattr__(self, k, v)
        self.save()

    def __setattr__(self, k, v):
        if not k.startswith("_") and hasattr(self, "_attrs"):
            self._attrs[k] = v
        object.__setattr__(self, k, v)

    def items(self):
        """Live (name, value) pairs of the tracked attributes."""
        return [(k, getattr(self, k)) for k in self._attrs]

    def committed_items(self):
        """(name, value) pairs of the last committed snapshot (what
        ``checkpoint.save_state`` persists)."""
        assert self._saved is not None
        return list(self._saved.items())

    def save(self) -> None:
        self._saved = copy.deepcopy(
            {k: getattr(self, k) for k in self._attrs})

    def restore(self) -> None:
        assert self._saved is not None
        for k, v in copy.deepcopy(self._saved).items():
            object.__setattr__(self, k, v)
            self._attrs[k] = v

    def sync(self) -> None:
        from ..functions import broadcast_object

        synced = broadcast_object(
            {k: getattr(self, k) for k in self._attrs}, root_rank=0,
            name="elastic_state")
        for k, v in synced.items():
            object.__setattr__(self, k, v)
            self._attrs[k] = v
        self.save()


# A driver-managed worker's "a PEER failed, not me": the driver restarts
# the epoch without blacklisting this host.
PEER_FAILURE_EXIT_CODE = 79
# "The topology changed; restart me with fresh assignments", from a
# HostsUpdatedInterrupt at a commit() point (or a preemption).
HOSTS_UPDATED_EXIT_CODE = 80

_COMM_FAILURE_MARKERS = (
    "unavailable", "deadline", "connection", "socket", "closed",
    "heartbeat", "preempt", "coordination", "peer", "barrier", "aborted",
    "internal", "timed out", "timeout", "broken pipe", "reset by")


def _is_comm_failure(e: BaseException) -> bool:
    """Whether ``e`` is a failure of the distributed runtime (a dead
    peer, a torn connection, a timed-out collective): a
    :class:`HorovodInternalError`, or an exception torch.distributed
    raised (``DistError`` and its subclasses, or a ``RuntimeError`` of
    gloo or NCCL) that carries a comm marker. Anything else — a user's
    ``ConnectionError``, ``ValueError('closed file')`` — surfaces."""
    if isinstance(e, HorovodInternalError):
        return True
    import torch.distributed as dist

    msg = str(e).lower()
    if isinstance(e, dist.DistError):
        runtime_origin = True
    else:
        runtime_origin = type(e) is RuntimeError and (
            "gloo" in msg or "nccl" in msg or "c10d" in msg)
    if not runtime_origin:
        return False
    return any(m in msg for m in _COMM_FAILURE_MARKERS)


def run(func: Callable) -> Callable:
    """Decorator: the elastic retry loop::

        while True:
            state.sync()
            try: return func(state, ...)
            except <comm failure>: state.restore()   # a peer died
            except HostsUpdatedInterrupt: pass       # topology changed
            reset(); state.on_reset()

    With a backoff between resets (``HVD_TPU_ELASTIC_RESET_BACKOFF_
    {BASE_S,MAX_S,DEADLINE_S}``) and a reset limit
    (``HVD_TPU_ELASTIC_RESET_LIMIT``, 100). Under a driver-managed launch
    a peer failure exits ``PEER_FAILURE_EXIT_CODE`` and a host update
    ``HOSTS_UPDATED_EXIT_CODE`` (see the module docstring)."""

    def wrapper(state: State, *args, **kwargs):
        import sys

        from . import basics

        install_preemption_handler()
        driver_managed = bool(runtime_env("RENDEZVOUS"))
        reset_limit = int(runtime_env("ELASTIC_RESET_LIMIT", "100"))
        backoff = faults_lib.Backoff.from_env(
            "HVD_TPU_ELASTIC_RESET_BACKOFF", base_s=0.25, cap_s=10.0)
        # The backoff meters one recovery episode: a fault after a
        # healthy stretch starts it over.
        heal_s = max(60.0, backoff.cap_s * 2)
        episode_anchor = time.monotonic()

        def on_fault():
            nonlocal episode_anchor
            now = time.monotonic()
            if now - episode_anchor > heal_s:
                backoff.reset()
            episode_anchor = now

        resets = 0
        skip_sync = False
        while True:
            try:
                # sync() inside the envelope: a peer dying mid-broadcast
                # is as recoverable as one dying mid-step.
                if not skip_sync:
                    state.sync()
                return func(state, *args, **kwargs)
            except HostsUpdatedInterrupt as e:
                logger.info("elastic: hosts updated; re-initializing")
                on_fault()
                skip_sync = e.skip_sync
                if driver_managed:
                    sys.exit(HOSTS_UPDATED_EXIT_CODE)
            except Exception as e:  # noqa: BLE001 — classified below
                # The black box of a fatal StallTimeoutError,
                # MismatchError or NonFiniteError, whatever path it took
                # here, before the retry loop tears the evidence down.
                from . import flightrec as flightrec_lib

                flightrec_lib.maybe_dump_for(e)
                if not _is_comm_failure(e):
                    raise
                logger.warning("elastic: collective failure (%s); rolling "
                               "back to last commit", e)
                on_fault()
                state.restore()
                faults_lib.stats.bump("restores")
                skip_sync = False
                if driver_managed:
                    # The epoch is dying: this rank's ring is the healthy
                    # half of the post-mortem. Dumping here is
                    # deterministic (the driver's SIGUSR2 reaches only
                    # workers still alive when it fires); fallback=True
                    # keeps a specific stall/mismatch box of this process.
                    flightrec_lib.recorder().dump(
                        "peer_failure",
                        reason=f"{type(e).__name__}: {e}",
                        fallback=True)
                    logger.warning(
                        "elastic: exiting for driver-managed restart "
                        "(peer failure, exit code %d)",
                        PEER_FAILURE_EXIT_CODE)
                    sys.exit(PEER_FAILURE_EXIT_CODE)
            resets += 1
            faults_lib.stats.bump("resets")
            if resets > reset_limit:
                raise RuntimeError(
                    f"elastic reset limit ({reset_limit}) exceeded")
            t0 = time.monotonic()
            if not backoff.sleep():
                raise RuntimeError(
                    "elastic reset deadline "
                    f"({backoff.deadline_s}s) exceeded after "
                    f"{resets} resets")
            _reset(basics)
            state.on_reset()
            faults_lib.stats.add_downtime(time.monotonic() - t0)

    return wrapper


def _reset(basics_mod) -> None:
    """Tear the runtime down and initialize it again against the
    (possibly changed) world; the next ``init()`` meets under a fresh
    store prefix."""
    settings = None
    if basics_mod.is_initialized():
        ctx = basics_mod.context()
        settings = {"device": "cpu"} if ctx.device.type == "cpu" else {}
        if ctx.backend == "gloo" and ctx.device.type != "cpu":
            settings["backend"] = "gloo"
        basics_mod.shutdown()
    basics_mod.init(**(settings or {}))
