"""Chrome-trace timeline of the eager collectives — the port of
``horovod_tpu/common/timeline.py``.

``start(filename)`` opens the trace; the engine then writes a begin
event when a collective is submitted (activity ``ALLREDUCE``,
``ALLGATHER``, ...; the event's ``tid`` is the tensor's full name, cut to
63 bytes by the native writer, and the Python writer's ``cat`` too) and
an end event when its result is synchronized. ``DistributedOptimizer``
writes each fused bucket the same way, as ``ALLREDUCE`` on ``tid``
``bucket.<index>``: begin when the bucket is handed to its reduction,
end when ``synchronize()`` has its result.

``ts`` is microseconds since the epoch (``time.time_ns() / 1e3`` read
when the timeline starts, ``perf_counter`` after it), the clock a
``torch.profiler`` trace takes its ``baseTimeNanoseconds`` from: the
same instant reads ``ts`` in the timeline and ``ts +
baseTimeNanoseconds / 1000`` in the profiler's Chrome trace. The writer is
the native one (``native/timeline.cc``: an MPSC ring drained by a
writer thread, dropping and counting events when the ring is full —
:meth:`Timeline.dropped`), or, under ``HVD_TPU_DISABLE_NATIVE=1``, a
Python queue and thread; both stream the events to disk as they arrive
and ``stop()`` closes the JSON. The file opens in ``chrome://tracing``
or Perfetto.

``start(..., xprof_dir=)`` also runs a ``torch.profiler`` trace (CPU and,
where there is one, CUDA activity) and writes it as a chrome trace into
that directory at ``stop()`` — the JAX package's ``jax.profiler``
bridge. :func:`readiness_order_from_trace` reads a trace back as the
tensors' first-event order, the measured order the fusion planner's
explicit ``order=`` takes.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import List, Optional

# Recovery-counter bumps land in the trace as instant events
# ``RECOVERY:<counter>``.
RECOVERY = "RECOVERY"


def readiness_order_from_trace(filename: str,
                               activity: Optional[str] = None
                               ) -> List[str]:
    """Tensor names of a chrome-trace file, the earliest first event
    first (ties by name). ``activity`` keeps only events of that name
    (e.g. ``ALLREDUCE``). Measure once and ship the list with the job:
    orders measured per rank would give diverged bucket plans."""
    with open(filename) as f:
        data = json.load(f)
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    first = {}
    for e in events:
        if not isinstance(e, dict) or e.get("ph") not in ("B", "X", "i"):
            continue
        if activity is not None and e.get("name") != activity:
            continue
        name = e.get("cat") or e.get("tid")
        if not name or name == "marker":
            continue
        ts = float(e.get("ts", 0.0))
        if name not in first or ts < first[name]:
            first[name] = ts
    return sorted(first, key=lambda n: (first[n], n))


def _wall_offset_us() -> float:
    """Epoch microseconds less ``perf_counter`` microseconds, now."""
    return time.time_ns() / 1e3 - time.perf_counter() * 1e6


class Timeline:
    """Writes chrome-trace JSON events; safe to call from any thread."""

    def __init__(self, filename: Optional[str] = None,
                 mark_cycles: bool = False):
        self._filename = filename
        self._mark_cycles = mark_cycles
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._active = False
        self._offset_us = _wall_offset_us()
        self._lock = threading.Lock()
        self._native = None
        self._last_dropped = 0
        self._profiler = None
        self._xprof_dir: Optional[str] = None
        if filename:
            self.start(filename)

    def start(self, filename: str, mark_cycles: Optional[bool] = None,
              xprof_dir: Optional[str] = None) -> None:
        """Open the trace (a running timeline keeps its file). The native
        writer is loaded here, not at construction, so a context that
        never traces never builds it; it raises when it cannot be built
        (unless ``HVD_TPU_DISABLE_NATIVE=1``)."""
        with self._lock:
            if mark_cycles is not None:
                self._mark_cycles = mark_cycles
            if xprof_dir and self._profiler is None:
                self._start_profiler(xprof_dir)
            if self._active:
                return
            self._filename = filename
            self._offset_us = _wall_offset_us()
            from ..native import NativeTimelineWriter

            native = NativeTimelineWriter()
            if native.available:
                if not native.start(filename):
                    raise OSError(f"timeline: the native writer could not "
                                  f"open {filename!r} (or another "
                                  "timeline of this process is running)")
                self._native = native
                self._active = True
                return
            self._active = True
            self._thread = threading.Thread(target=self._writer,
                                            daemon=True)
            self._thread.start()

    def _start_profiler(self, xprof_dir: str) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        self._profiler, self._xprof_dir = prof, xprof_dir

    def stop(self) -> None:
        with self._lock:
            prof, xdir = self._profiler, self._xprof_dir
            self._profiler = self._xprof_dir = None
        try:
            if prof is not None:
                prof.__exit__(None, None, None)
                os.makedirs(xdir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    xdir, f"torch_trace.{os.getpid()}.json"))
        finally:
            with self._lock:
                if not self._active:
                    return
                self._active = False
                native, self._native = self._native, None
            if native is not None:
                native.stop()
                self._last_dropped = native.dropped()
                return
            self._queue.put(None)
            if self._thread:
                self._thread.join(timeout=5)
                self._thread = None

    @property
    def active(self) -> bool:
        return self._active

    @property
    def native(self) -> bool:
        """True while the native writer records."""
        return self._native is not None

    def dropped(self) -> int:
        """Events the native writer dropped on a full ring (the running
        writer's, else the last stopped one's; 0 for the Python
        writer, which never drops)."""
        native = self._native
        return native.dropped() if native is not None \
            else self._last_dropped

    def _now_us(self) -> float:
        """Microseconds since the epoch, the profiler's base clock, as
        read when the timeline started; ``perf_counter`` since then, so
        a reset of the system clock moves no event."""
        return time.perf_counter() * 1e6 + self._offset_us

    def _emit(self, tid: str, name: str, phase: str, ev: dict) -> None:
        native = self._native
        if native is not None:
            native.event(tid, name, phase, ev["ts"])
        else:
            self._queue.put(ev)

    def begin(self, tensor_name: str, activity: str) -> None:
        if self._active:
            self._emit(tensor_name, activity, "B",
                       {"name": activity, "cat": tensor_name, "ph": "B",
                        "ts": self._now_us(), "pid": os.getpid(),
                        "tid": tensor_name})

    def end(self, tensor_name: str, activity: Optional[str] = None) -> None:
        if self._active:
            self._emit(tensor_name, activity or "", "E",
                       {"name": activity or "", "cat": tensor_name,
                        "ph": "E", "ts": self._now_us(), "pid": os.getpid(),
                        "tid": tensor_name})

    def instant(self, name: str) -> None:
        if self._active:
            self._emit("marker", name, "i",
                       {"name": name, "ph": "i", "ts": self._now_us(),
                        "pid": os.getpid(), "tid": "marker", "s": "g"})

    def mark_cycle(self) -> None:
        """A ``CYCLE`` instant when cycle marks are on (the reference's
        HOROVOD_TIMELINE_MARK_CYCLES)."""
        if self._mark_cycles:
            self.instant("CYCLE")

    def recovery(self, counter: str) -> None:
        """A recovery-counter bump as the instant ``RECOVERY:<counter>``."""
        self.instant(f"{RECOVERY}:{counter}")

    def _writer(self) -> None:
        try:
            f = open(self._filename, "w")
        except OSError:
            while self._queue.get() is not None:
                pass
            return
        with f:
            f.write('{"displayTimeUnit": "ms", "traceEvents": [\n')
            first = True
            while True:
                ev = self._queue.get()
                if ev is None:
                    break
                if not first:
                    f.write(",\n")
                json.dump(ev, f)
                first = False
                if self._queue.empty():
                    f.flush()
            f.write("\n]}\n")
