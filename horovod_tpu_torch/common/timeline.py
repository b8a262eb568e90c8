"""Chrome-trace timeline of the eager collectives — the port of
``horovod_tpu/common/timeline.py``'s ``Timeline``.

``start(filename)`` opens the trace; the engine then writes a begin
event when a collective is submitted (activity ``ALLREDUCE``,
``ALLGATHER``, ...; the event's ``cat`` and ``tid`` are the tensor's full
name) and an end event when its result is synchronized. A writer thread
streams the events to disk as they arrive, so a long traced run holds
nothing in memory; ``stop()`` closes the JSON. The file opens in
``chrome://tracing`` or Perfetto. The JAX package's native writer and
its profiler bridge are not ported.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Optional


class Timeline:
    """Writes chrome-trace JSON events; safe to call from any thread."""

    def __init__(self, filename: Optional[str] = None,
                 mark_cycles: bool = False):
        self._filename = filename
        self._mark_cycles = mark_cycles
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._active = False
        self._start_ts = time.perf_counter()
        self._lock = threading.Lock()
        if filename:
            self.start(filename)

    def start(self, filename: str, mark_cycles: Optional[bool] = None
              ) -> None:
        with self._lock:
            if mark_cycles is not None:
                self._mark_cycles = mark_cycles
            if self._active:
                return
            self._filename = filename
            self._active = True
            self._thread = threading.Thread(target=self._writer,
                                            daemon=True)
            self._thread.start()

    def stop(self) -> None:
        with self._lock:
            if not self._active:
                return
            self._active = False
        self._queue.put(None)
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None

    def _now_us(self) -> float:
        return (time.perf_counter() - self._start_ts) * 1e6

    def begin(self, tensor_name: str, activity: str) -> None:
        if self._active:
            self._queue.put({"name": activity, "cat": tensor_name,
                             "ph": "B", "ts": self._now_us(),
                             "pid": os.getpid(), "tid": tensor_name})

    def end(self, tensor_name: str, activity: Optional[str] = None) -> None:
        if self._active:
            self._queue.put({"name": activity or "", "cat": tensor_name,
                             "ph": "E", "ts": self._now_us(),
                             "pid": os.getpid(), "tid": tensor_name})

    def instant(self, name: str) -> None:
        if self._active:
            self._queue.put({"name": name, "ph": "i", "ts": self._now_us(),
                             "pid": os.getpid(), "tid": "marker", "s": "g"})

    def mark_cycle(self) -> None:
        """A ``CYCLE`` instant when cycle marks are on (the reference's
        HOROVOD_TIMELINE_MARK_CYCLES)."""
        if self._mark_cycles:
            self.instant("CYCLE")

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
