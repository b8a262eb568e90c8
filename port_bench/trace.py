"""Reading a ``torch.profiler`` Chrome trace of a few training steps.

The profiled steps are the host ranges the harness marks with
``record_function(STEP)``; the device work of those steps is every kernel,
copy and set whose launch (a CUDA API event, category ``cuda_*``, with
the same ``correlation``) lies inside them, whatever the thread. The span
runs from the first such device event's start to the last one's end.
Times are microseconds as the trace has them."""

from __future__ import annotations

import bisect
import gzip
import json
from typing import Dict, Iterable, List, Sequence, Tuple

STEP = "port_bench.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")

Interval = Tuple[float, float]


def load(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same time."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def length(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in intervals)


def intersect(xs: Sequence[Interval], ys: Sequence[Interval]
              ) -> List[Interval]:
    """The overlap of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def summarize(events: List[dict], skip_first: int = 1) -> Dict:
    """The profiled steps of one rank's trace, leaving out the first
    ``skip_first`` marked steps (the host catching up after the profiler
    started): ``steps``, ``span`` (start, end), ``device`` events as
    ``(name, start, end, cat)`` and ``gaps`` (the idle stretches inside the
    span, each named by the innermost host range running on the stepping
    thread at its middle)."""
    marks = sorted((e for e in events if e.get("name") == STEP
                    and e.get("cat") == "user_annotation"
                    and e.get("ph") == "X"), key=lambda e: e["ts"])
    marks = marks[skip_first:]
    if not marks:
        return {"steps": 0, "span": None, "device": [], "gaps": []}
    lo = marks[0]["ts"]
    hi = marks[-1]["ts"] + marks[-1]["dur"]
    tid = marks[0]["tid"]
    corr = {e["args"]["correlation"] for e in events
            if str(e.get("cat", "")).startswith("cuda_")
            and lo <= e.get("ts", -1) <= hi
            and "correlation" in e.get("args", {})}
    device = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
               e["cat"]) for e in events
              if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
              and e.get("args", {}).get("correlation") in corr]
    if not device:
        return {"steps": len(marks), "span": None, "device": [], "gaps": []}
    span = (min(d[1] for d in device), max(d[2] for d in device))
    busy = union((d[1], d[2]) for d in device)
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") in HOST_CATS and e.get("ph") == "X"
                   and e.get("tid") == tid and "dur" in e),
                  key=lambda h: h[0])
    starts = [h[0] for h in host]
    gaps = []
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        name = "(no host range)"
        k = bisect.bisect_right(starts, mid)
        best = None
        # The innermost range covering mid starts last among those that
        # cover it; look back over the ranges that started before mid.
        for h in reversed(host[max(0, k - 400):k]):
            if h[1] >= mid:
                best = h
                break
        if best is not None:
            name = best[2]
        gaps.append((name, b - a))
    return {"steps": len(marks), "span": span, "device": device,
            "gaps": gaps}


def busy(summary: Dict) -> float:
    """Microseconds in which some device event ran."""
    return length(union((d[1], d[2]) for d in summary["device"]))


def exposed(summary: Dict, is_comm) -> float:
    """Microseconds of the device events ``is_comm(name)`` selects that no
    other kernel overlaps."""
    comm = union((d[1], d[2]) for d in summary["device"]
                 if d[3] == "kernel" and is_comm(d[0]))
    compute = union((d[1], d[2]) for d in summary["device"]
                    if d[3] == "kernel" and not is_comm(d[0]))
    return length(comm) - length(intersect(comm, compute))


def top(pairs: Iterable[Tuple[str, float]], n: int = 10
        ) -> List[Tuple[str, float]]:
    """The ``n`` names with the largest summed time."""
    total: Dict[str, float] = {}
    for name, t in pairs:
        total[name] = total.get(name, 0.0) + t
    return sorted(total.items(), key=lambda kv: -kv[1])[:n]
