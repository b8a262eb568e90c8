"""Reading the port's own spans from each rank's ``torch.profiler`` trace.

While a profiler records, the port opens a ``record_function`` range at
each layer boundary of its training path: ``hvd.infeed.next``,
``hvd.model.forward``, ``hvd.model.loss``, ``hvd.attn.fwd``,
``hvd.attn.bwd``, ``hvd.bucket/<index>/<wire bytes>``, ``hvd_step/comm``
and ``hvd.opt.apply``. Over the steps ``trace.summarize`` keeps (the
``trace.STEP`` marks after the first), a span name gives

* host time: the spans' own durations, summed;
* device time: the union of the kernels, copies and sets whose launch (a
  ``cuda_*`` event with the same ``correlation``) started inside one of
  the spans, on the span's own thread.

A trace without the span (a program that opens none) gives None. Times
are microseconds as the trace has them; the readers divide by the kept
steps and average over the ranks."""

from __future__ import annotations

import bisect
import os
import statistics
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from port_bench import card, trace
from port_bench.metrics.allreduce_exposed_ms import is_nccl

BUCKET = "hvd.bucket/"

Device = Tuple[str, float, float, str]     # as trace.summarize has them


def bucket_of(name: str) -> Optional[Tuple[int, int]]:
    """``(index, wire bytes)`` of a bucket span's name, else None."""
    if not name.startswith(BUCKET):
        return None
    index, nbytes = name[len(BUCKET):].split("/")
    return int(index), int(nbytes)


class Index:
    """One rank's trace over the steps ``trace.summarize`` keeps: its
    summary, the port's spans that start in those steps, every launch by
    thread, and the device events by correlation."""

    def __init__(self, events: List[dict], skip_first: int = 1):
        self.summary = trace.summarize(events, skip_first)
        self.steps = self.summary["steps"]
        #: name -> [(tid, start, end)], the spans starting in the steps
        self.spans: Dict[str, List[Tuple[object, float, float]]] = {}
        self._launches: Dict[object, List[Tuple[float, int]]] = {}
        self._device: Dict[int, List[Device]] = {}
        if not self.steps:
            return
        # The kept steps are the last ``steps`` marks, as the harness
        # reads them beside the summary.
        marks = sorted((float(e["ts"]), float(e["dur"])) for e in events
                       if e.get("name") == trace.STEP
                       and e.get("cat") == "user_annotation"
                       and e.get("ph") == "X")[-self.steps:]
        lo, hi = marks[0][0], marks[-1][0] + marks[-1][1]
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = str(e.get("cat", ""))
            ts, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            corr = e.get("args", {}).get("correlation")
            if cat == "user_annotation" and str(e.get("name", "")) \
                    .startswith("hvd") and lo <= ts <= hi:
                self.spans.setdefault(e["name"], []).append(
                    (e.get("tid"), ts, end))
            elif cat.startswith("cuda_") and corr is not None:
                self._launches.setdefault(e.get("tid"), []).append(
                    (ts, corr))
            elif cat in trace.DEVICE_CATS and corr is not None:
                self._device.setdefault(corr, []).append(
                    (e.get("name", ""), ts, end, cat))
        for launches in self._launches.values():
            launches.sort()

    def names(self, keep: Callable[[str], bool]) -> List[str]:
        return [n for n in self.spans if keep(n)]

    def host_us(self, names: Iterable[str]) -> Optional[float]:
        """The spans' own durations, summed; None without any."""
        spans = [s for n in names for s in self.spans.get(n, ())]
        return sum(b - a for _, a, b in spans) if spans else None

    def device_events(self, names: Iterable[str]) -> Optional[List[Device]]:
        """Device events launched inside the spans, each once; None
        without any span."""
        spans = [s for n in names for s in self.spans.get(n, ())]
        if not spans:
            return None
        seen, out = set(), []
        for tid, a, b in spans:
            launches = self._launches.get(tid, [])
            i = bisect.bisect_left(launches, (a, -1))
            while i < len(launches) and launches[i][0] <= b:
                corr = launches[i][1]
                if corr not in seen:
                    seen.add(corr)
                    out.extend(self._device.get(corr, ()))
                i += 1
        return out

    def device_us(self, names: Iterable[str]) -> Optional[float]:
        """The union of the device events launched inside the spans."""
        events = self.device_events(names)
        if events is None:
            return None
        return trace.length(trace.union((d[1], d[2]) for d in events))

    def exposed_nccl_us(self, names: Iterable[str]) -> Optional[float]:
        """``trace.exposed`` of the NCCL kernels launched inside the
        spans, against every other kernel of the summary."""
        events = self.device_events(names)
        if events is None:
            return None
        return trace.exposed(
            {"device": [d for d in events if is_nccl(d[0])]
             + [d for d in self.summary["device"] if not is_nccl(d[0])]},
            is_nccl)


def indexes(ctx) -> List[Index]:
    """Each rank's index with kept steps, read once a run (kept on
    ``ctx``: every reader of the run shares it)."""
    cache = ctx.__dict__.setdefault("_span_indexes", {})
    out = []
    for t in ctx.traces():
        path = os.path.join(card.ROOT, t["path"])
        if path not in cache:
            cache[path] = Index(trace.load(path))
        if cache[path].steps:
            out.append(cache[path])
    return out


def per_step_ms(ctx, value: Callable[[Index], Optional[float]]
                ) -> Optional[float]:
    """``value(index)`` (microseconds) over the kept steps in ms, mean
    over the ranks that have it; None where no rank has it."""
    got = []
    for ix in indexes(ctx):
        v = value(ix)
        if v is not None:
            got.append(v * 1e-3 / ix.steps)
    return statistics.fmean(got) if got else None
