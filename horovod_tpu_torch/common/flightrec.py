"""Flight recorder — the per-process black box for post-mortems; the
port's copy of ``horovod_tpu/common/flightrec.py``.

A distributed stall is invisible from any single rank: when the job
hangs, the question is "what was every rank doing, and which one never
arrived". This module answers it without a live trace session:

* :class:`FlightRecorder` — a fixed-size, lock-cheap ring of the last N
  events (``HVD_TPU_FLIGHTREC_SIZE``, default 256): op kind, the eager
  engine's ``kind.name`` signature, payload bytes, wire, training step,
  submit/complete monotonic timestamps and outcome. The eager engine
  feeds it at submit and completion, the serve engine per decode round
  (op ``serve``); the :class:`~.stall.StallInspector` marks aging events
  ``stalled``. Each event carries a process-wide sequence number: every
  rank issues its collectives in one program order, so seq ``k`` is the
  SAME collective on every rank, which is what ``tools/flight_diff.py``
  aligns on.
* **Black-box dump**: on ``StallTimeoutError``, ``MismatchError``, a
  fatal non-finite abort (``NonFiniteError``) or ``SIGUSR2``, the ring,
  all-thread Python stacks, the stall inspector's in-flight table and
  the recovery counters are written as ONE JSON object to
  ``HVD_TPU_FLIGHTREC_DIR/blackbox.rank<r>.json`` (tmp file, then
  rename) and — when the rendezvous KV is reachable — pushed under
  ``flightrec/blackbox.<rank>`` so the elastic driver can collect boxes
  from ranks whose filesystem it cannot read.
* The elastic driver sends ``SIGUSR2`` to every surviving worker when
  an epoch fails, so one rank's fatal error yields a black box from
  EVERY rank — the merged view ``flight_diff`` turns into "rank 1 never
  submitted allreduce.grad at step 12".

The ring holds host data only (names, ints, floats): the SIGUSR2 dump
touches no CUDA state. Knobs: ``HVD_TPU_FLIGHTREC`` (default on),
``HVD_TPU_FLIGHTREC_SIZE``, ``HVD_TPU_FLIGHTREC_DIR`` (default
``results/flightrec/``), ``HVD_TPU_FLIGHTREC_PUSH`` (the KV push,
default on when ``HVD_TPU_RENDEZVOUS`` is set). The black box's
``role`` is always "" here: the port has no hybrid ParallelSpec yet.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import lockdep
from . import metrics as metrics_lib
from .config import runtime_env

logger = logging.getLogger("horovod_tpu_torch")

ENV_ENABLE = "HVD_TPU_FLIGHTREC"
ENV_SIZE = "HVD_TPU_FLIGHTREC_SIZE"
ENV_DIR = "HVD_TPU_FLIGHTREC_DIR"
ENV_PUSH = "HVD_TPU_FLIGHTREC_PUSH"

KV_SCOPE = "flightrec"          # rendezvous KV scope for pushed boxes

# Black-box schema: ONE JSON object per dump, the JAX package's v3 —
# tools/flight_diff.py carries the same two tuples, so the schema cannot
# drift between writer and reader. ``role`` is the rank's (dp,pp,tp)
# label under a hybrid spec ("" when role-blind); ``trace`` is the
# request-id CSV the serve engine stamps per decode event ("" for
# training collectives).
BLACKBOX_SCHEMA_VERSION = 3
BLACKBOX_KEYS = ("schema", "rank", "host", "role", "pid", "trigger",
                 "reason", "t_unix", "step", "seq_head", "events",
                 "stacks", "stall_inflight", "recovery")
EVENT_KEYS = ("seq", "op", "name", "step", "bytes", "wire",
              "t_submit", "t_complete", "outcome", "trace")

_M_EVENTS = metrics_lib.counter(
    "hvd_tpu_flightrec_events_total",
    "collective events recorded into the flight-recorder ring")
_M_DUMPS = metrics_lib.counter(
    "hvd_tpu_flightrec_dumps_total",
    "black-box dumps by trigger (stall_timeout/mismatch/nonfinite/"
    "peer_failure/sigusr2/exit)",
    labels=("trigger",))
for _t in ("stall_timeout", "mismatch", "nonfinite", "peer_failure",
           "sigusr2", "exit"):
    _M_DUMPS.labels(trigger=_t)
del _t


def _truthy(raw: Optional[str], default: bool) -> bool:
    if raw is None:
        return default
    return raw.strip().lower() not in ("0", "false", "no", "off", "")


class _Event:
    __slots__ = ("seq", "op", "name", "step", "bytes", "wire",
                 "t_submit", "t_complete", "outcome", "trace")

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
        return {"seq": self.seq, "op": self.op, "name": self.name,
                "step": self.step, "bytes": self.bytes,
                "wire": self.wire, "t_submit": self.t_submit,
                "t_complete": self.t_complete, "outcome": self.outcome,
                "trace": self.trace}


class FlightRecorder:
    """Fixed-size ring of collective events + the black-box writer.

    Lock-cheap: one lock, held only for the dict/list writes of a
    record/complete (nanoseconds — the same budget as the stall
    inspector's bookkeeping, off the device-dispatch critical path).
    """

    def __init__(self, size: int = 256, directory: Optional[str] = None,
                 rank: Optional[int] = None, host: Optional[str] = None,
                 push: Optional[bool] = None,
                 enabled: Optional[bool] = None):
        if enabled is None:
            enabled = _truthy(runtime_env("FLIGHTREC"), True)
        self.enabled = bool(enabled)
        if size is None:
            size = 256
        self.size = max(8, int(size))
        # Default under results/ (gitignored), not whatever cwd the job
        # died in.
        self.directory = (directory if directory is not None
                          else runtime_env("FLIGHTREC_DIR")
                          or os.path.join("results", "flightrec"))
        # HVD_TPU_PROC_ID (the launcher's identity of this worker) wins
        # over an explicit rank, as in the JAX package: N workers must
        # not collapse onto one blackbox.rank0.json / KV key.
        env_rank = runtime_env("PROC_ID")
        if env_rank is not None:
            try:
                rank = int(env_rank)
            except ValueError:
                pass
        self.rank = int(rank) if rank is not None else 0
        self.host = (host if host is not None
                     else runtime_env("HOSTNAME", ""))
        self.role = ""
        self._push = push
        self._lock = lockdep.lock("flightrec.ring")
        self._ring: List[Optional[_Event]] = [None] * self.size
        self._by_name: Dict[str, _Event] = {}   # pending events only
        self._seq = 0
        self.step = 0
        self._dumped_triggers: set = set()
        self._stall_inspector = None    # wired by init()

    # -- the hot path (eager engine submit/complete) -----------------------

    def record_submit(self, name: str, op: str) -> int:
        """Record a submitted collective; returns its sequence number.
        ``name`` is the engine's full ``kind.name`` signature."""
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
        """Attach payload facts to the in-flight event (called from the
        engine's byte-accounting path once the wire decision is made).
        ``trace`` is the serve plane's request-id CSV."""
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
        """Complete the in-flight event. First completion wins: an
        error outcome recorded on the exception path is not overwritten
        by the finalizer's eventual ``ok``."""
        if not self.enabled:
            return
        now = time.monotonic()
        with self._lock:
            ev = self._by_name.pop(name, None)
            if ev is None or ev.t_complete is not None:
                return
            ev.t_complete = now
            ev.outcome = outcome

    def mark_stalled(self, name: str) -> None:
        """StallInspector warning: the event aged past check_time while
        still in flight — visible in the ring even before any dump."""
        if not self.enabled:
            return
        with self._lock:
            ev = self._by_name.get(name)
            if ev is not None and ev.outcome == "pending":
                ev.outcome = "stalled"

    def advance_step(self, step: Optional[int] = None) -> None:
        """Stamp the training-step counter onto subsequent events
        (bumped once per ``State.commit()``; settable for loops that
        track their own step)."""
        if step is not None:
            self.step = int(step)
        else:
            self.step += 1

    # -- snapshots ----------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        """Ring contents, oldest first."""
        with self._lock:
            seq = self._seq
            ring = list(self._ring)
        out: List[Dict[str, Any]] = []
        if seq <= self.size:
            ordered = ring[:seq]
        else:
            head = seq % self.size
            ordered = ring[head:] + ring[:head]
        for ev in ordered:
            if ev is not None:
                out.append(ev.to_dict())
        return out

    def pending(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [ev.to_dict() for ev in self._by_name.values()]

    # -- the black box ------------------------------------------------------

    def blackbox(self, trigger: str, reason: str = "") -> Dict[str, Any]:
        """Assemble the dump payload (schema: BLACKBOX_KEYS)."""
        stacks = metrics_lib.thread_stacks()
        inflight: Dict[str, float] = {}
        insp = self._stall_inspector
        if insp is not None:
            try:
                now = time.monotonic()
                inflight = {n: round(now - t0, 3)
                            for n, t0 in insp.inflight().items()}
            except Exception:  # noqa: BLE001 — the box must still write
                pass
        from . import faults as faults_lib

        return {
            "schema": BLACKBOX_SCHEMA_VERSION,
            "rank": self.rank,
            "host": self.host,
            "role": self.role,
            "pid": os.getpid(),
            "trigger": trigger,
            "reason": reason,
            "t_unix": time.time(),
            "step": self.step,
            "seq_head": self._seq,
            "events": self.events(),
            "stacks": stacks,
            "stall_inflight": inflight,
            "recovery": faults_lib.stats.snapshot(),
        }

    def box_path(self) -> str:
        return os.path.join(self.directory,
                            f"blackbox.rank{self.rank}.json")

    def dump(self, trigger: str, reason: str = "",
             once_per_trigger: bool = True,
             fallback: bool = False) -> Optional[str]:
        """Write the black box (atomic tmp+rename) and push it to the
        controller KV when reachable. Returns the file path, or None
        when disabled / deduplicated. ``once_per_trigger`` keeps the
        FIRST box for a trigger class: the watchdog's dump at stall
        latch time (hung op still pending in the ring) must not be
        overwritten by the re-raise on the next submit. ``fallback``
        dumps only when NO box has been written yet this process — the
        generic peer-failure box must not overwrite a specific
        stall/mismatch one (one file per rank; last write wins)."""
        if not self.enabled:
            return None
        with self._lock:
            if fallback and self._dumped_triggers:
                return None
            if once_per_trigger and trigger in self._dumped_triggers:
                return None
            self._dumped_triggers.add(trigger)
        box = self.blackbox(trigger, reason)
        path = self.box_path()
        try:
            os.makedirs(self.directory, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(box, f)
            os.replace(tmp, path)
            _M_DUMPS.labels(trigger=trigger).inc()
            logger.warning(
                "flightrec: black box written to %s (trigger=%s%s)",
                path, trigger, f", {reason}" if reason else "")
        except OSError as e:
            logger.warning("flightrec: black-box write failed (%s)", e)
            path = None
            # Unlatch: a failed write (full disk, unmounted volume)
            # must not suppress a retry of this trigger or a later
            # fallback dump — the rank would end the run box-less.
            with self._lock:
                self._dumped_triggers.discard(trigger)
        self._push_kv(box)
        return path

    def _push_kv(self, box: Dict[str, Any]) -> None:
        """Best-effort push to the rendezvous KV (no retries, short
        timeout — a dead controller must not delay the dump)."""
        rdv = runtime_env("RENDEZVOUS")
        push = (self._push if self._push is not None
                else _truthy(runtime_env("FLIGHTREC_PUSH"), True))
        if not rdv or not push:
            return
        try:
            from ..runner.rendezvous import RendezvousClient

            host, port = rdv.rsplit(":", 1)
            client = RendezvousClient(host, int(port), timeout_s=2.0,
                                      retries=0)
            client.put(KV_SCOPE, f"blackbox.{self.rank}",
                       json.dumps(box).encode())
        except Exception as e:  # noqa: BLE001 — push is best-effort
            logger.debug("flightrec: KV push failed (%s)", e)


# -- module-level singleton --------------------------------------------------

_recorder: Optional[FlightRecorder] = None
_recorder_lock = lockdep.lock("flightrec.module")


def recorder() -> FlightRecorder:
    """The process-wide recorder (env-configured on first use;
    ``init()`` replaces it with a config-built one via install())."""
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder(
                    size=_env_size(), directory=None)
                _register_finalizer()
    return _recorder


def _env_size() -> int:
    try:
        return int(runtime_env("FLIGHTREC_SIZE", "256"))
    except ValueError:
        return 256


def install(rec: FlightRecorder) -> FlightRecorder:
    """Install a config-built recorder as the process singleton (called
    by ``hvd.init()``; the old ring is discarded)."""
    global _recorder
    with _recorder_lock:
        _recorder = rec
        _register_finalizer()
    return rec


def _reset_for_tests() -> None:
    global _recorder
    with _recorder_lock:
        _recorder = None


def enabled() -> bool:
    return recorder().enabled


# -- dump triggers -----------------------------------------------------------

def _trigger_for(exc: BaseException) -> Optional[str]:
    """Map a fatal exception to its dump trigger class, or None for
    exceptions that are not black-box events (an ordinary ValueError
    must not dump)."""
    from .exceptions import MismatchError, NonFiniteError, StallError

    if isinstance(exc, StallError):
        return "stall_timeout"
    if isinstance(exc, MismatchError):
        return "mismatch"
    if isinstance(exc, NonFiniteError):
        return "nonfinite"
    return None


def maybe_dump_for(exc: BaseException) -> Optional[str]:
    """Dump a black box when ``exc`` is one of the fatal classes the
    pod post-mortem needs (StallTimeoutError / MismatchError /
    NonFiniteError). isinstance checks otherwise. Called from the eager
    engine's collective exception path, the elastic retry loop and
    ``integrity.check_abort``."""
    trigger = _trigger_for(exc)
    if trigger is None:
        return None
    return recorder().dump(trigger, reason=f"{type(exc).__name__}: {exc}")


def _on_sigusr2(signum, frame) -> None:
    # The handler runs on the main thread between bytecodes — which may
    # be INSIDE a `with lock:` block of the recorder, the metrics
    # registry or the stall inspector (the elastic driver sends SIGUSR2
    # exactly while survivors are submitting collectives). dump() takes
    # all three, and they are non-reentrant: acquiring them here would
    # deadlock against the suspended holder underneath. So the handler
    # only starts a short-lived thread, which waits until the
    # interrupted holder resumes and releases; the driver's
    # HVD_TPU_FLIGHTREC_SIGNAL_GRACE_S window covers the write. Nothing
    # here touches CUDA: the ring holds host values only.
    try:
        threading.Thread(target=_sigusr2_dump, daemon=True,
                         name="hvd-tpu-flightrec-dump").start()
    except Exception:  # noqa: BLE001 — interpreter teardown
        _sigusr2_dump()


def _sigusr2_dump() -> None:
    try:
        recorder().dump("sigusr2", once_per_trigger=False)
    except Exception:  # noqa: BLE001 — a handler must never raise
        logger.exception("flightrec: SIGUSR2 dump failed")


def install_signal_handler() -> bool:
    """Install the SIGUSR2 on-demand dump (main thread only; returns
    False when it cannot be installed — best-effort, like the
    preemption latch)."""
    import signal as signal_mod

    if not hasattr(signal_mod, "SIGUSR2"):  # windows
        return False
    try:
        signal_mod.signal(signal_mod.SIGUSR2, _on_sigusr2)
        return True
    except ValueError:  # not the main thread
        return False


def _register_finalizer() -> None:
    from . import shutdown as shutdown_lib

    shutdown_lib.register("flightrec", _finalize,
                          shutdown_lib.FLIGHTREC_PRIORITY)


def _finalize() -> None:
    """Shutdown-sequence leg: if the process is dying with collectives
    still in flight (a wedged run killed by the driver), write a final
    box so the post-mortem is never empty-handed. A clean exit (no
    pending events, no prior dump) writes nothing. From here on SIGUSR2
    is ignored: the interpreter's teardown restores the default action,
    which would let the elastic driver's dump request kill a worker
    that is already exiting (and count it as failed)."""
    import signal as signal_mod

    try:
        signal_mod.signal(signal_mod.SIGUSR2, signal_mod.SIG_IGN)
    except (AttributeError, ValueError):    # no SIGUSR2 / not main thread
        pass
    rec = _recorder
    if rec is None or not rec.enabled:
        return
    with rec._lock:
        pending = bool(rec._by_name)
        already = bool(rec._dumped_triggers)
    if pending and not already:
        rec.dump("exit", reason="process exit with collectives in "
                                "flight")


def note_commit() -> None:
    """Per-commit hook (``State.commit``): advance the step stamp. A bool
    check and an int increment when enabled; nothing otherwise."""
    rec = _recorder
    if rec is not None and rec.enabled:
        rec.advance_step()
