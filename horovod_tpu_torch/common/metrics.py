"""The process-wide metrics registry of the port — its copy of
``horovod_tpu/common/metrics.py``.

* **Counters / gauges / fixed-bucket histograms** with Prometheus-style
  labels, thread-safe, registered by name (one family per name,
  process-wide). The serve, eager, optimizer, stall, flight-recorder and
  autoscale modules register their ``hvd_tpu_*`` families here under the
  JAX package's names and labels.
* **Zero-cost disable**: with ``HVD_TPU_METRICS=0`` every constructor
  returns the module-level :data:`NOOP` singleton, so instrumented hot
  paths allocate nothing. The switch is read once, at import: turning
  telemetry off takes another process, not a toggle.
* **Three export surfaces**:

  1. :func:`snapshot` — the ``hvd.metrics()`` dict (JSON-able).
  2. :class:`MetricsDumper` / :func:`start_file_dump` — a daemon writer
     thread appending one JSON-lines snapshot to ``HVD_TPU_METRICS_FILE``
     every ``HVD_TPU_METRICS_INTERVAL_S`` seconds, with a final
     drain-on-stop dump.
  3. :class:`MetricsServer` / :func:`serve` — Prometheus text on
     ``/metrics`` and the snapshot on ``/metrics.json`` from a
     background ``ThreadingHTTPServer`` (``common/httpd.py``), plus
     ``/debug/stacks`` and ``/debug/profile`` under
     ``HVD_TPU_METRICS_DEBUG=1``. Every sample carries the process's
     global labels (``rank``/``size``/``host``, stamped by
     ``hvd.init()``) so a pod scrape aggregates by rank.

* **The profiler bridge**: :func:`span` opens a
  ``torch.profiler.record_function`` range while :func:`tracing` holds:
  while a ``torch.profiler`` (or ``emit_nvtx``) records on the calling
  thread, or with ``HVD_TPU_METRICS_TRACE=1`` (or
  :func:`enable_trace_bridge`). :meth:`Histogram.time` spans and
  :func:`step_annotation` open theirs under the same test, so the
  host-side phase timings line up with a profiler trace of the card,
  on its clock. Otherwise a span is the shared no-op: one test of the
  profiler's state.

Stdlib-only at import (torch loads lazily inside the bridge and the
profile capture), so any layer can import it without cycles.
"""

from __future__ import annotations

import json
import math
import os
import re
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import lockdep
from .config import runtime_env

ENV_ENABLE = "HVD_TPU_METRICS"          # "0"/"false" disables the registry
ENV_FILE = "HVD_TPU_METRICS_FILE"       # JSON-lines dump path
ENV_INTERVAL = "HVD_TPU_METRICS_INTERVAL_S"
ENV_PORT = "HVD_TPU_METRICS_PORT"       # /metrics endpoint (0 = ephemeral)
ENV_TRACE = "HVD_TPU_METRICS_TRACE"     # torch.profiler bridge
ENV_DEBUG = "HVD_TPU_METRICS_DEBUG"     # /debug/* on-demand capture
# Upper bound for one /debug/profile?ms= capture: the handler thread
# sleeps for the window, so an unbounded request would pin it.
PROFILE_MS_CAP = 60_000

# Default latency buckets (seconds): sub-ms dispatch latencies up to
# multi-second stalled collectives — fixed at registration (Prometheus
# histograms must keep bucket bounds stable across scrapes).
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _truthy(raw: Optional[str], default: bool) -> bool:
    if raw is None:
        return default
    return raw.strip().lower() not in ("0", "false", "no", "off", "")


# -- no-op singletons (the HVD_TPU_METRICS=0 hot path) ----------------------

class _NoopTimer:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_TIMER = _NoopTimer()


class NoopMetric:
    """Universal no-op stand-in for every metric type. ONE instance
    (:data:`NOOP`) serves every name/label combination of a disabled
    registry, so instrumented hot paths cost a method call on a shared
    singleton and allocate nothing."""

    __slots__ = ()

    def labels(self, **kwargs):
        return self

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def time(self, annotation: Optional[str] = None):
        return _NOOP_TIMER


NOOP = NoopMetric()


# -- live metric families ---------------------------------------------------

def _escape_label(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_value(v: float) -> str:
    # Non-finite first: int(inf)/int(nan) raise, and a diverging run CAN
    # publish inf/nan (e.g. the EF residual norm) — the scrape must keep
    # working exactly then. Prometheus spec spellings: +Inf/-Inf/NaN.
    if not math.isfinite(v):
        if math.isnan(v):
            return "NaN"
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return format(v, ".10g")


class _Child:
    """One labeled sample of a family; holds (family, label-value key)."""

    __slots__ = ("_family", "_key")

    def __init__(self, family: "_Family", key: Tuple[str, ...]):
        self._family = family
        self._key = key


class _Family:
    """Base metric family: a name + label schema + per-label-set state.

    Thread-safe: one lock per family serializes child creation and
    value updates (updates are dict writes — the lock is held for
    nanoseconds, off the device-dispatch critical path)."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: Sequence[str]):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name: {name!r}")
        for l in labelnames:
            if not _LABEL_RE.match(l):
                raise ValueError(f"invalid label name: {l!r}")
        self.registry = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lockdep.lock("metrics.family")
        self._children: Dict[Tuple[str, ...], Any] = {}
        if not self.labelnames:
            # Unlabeled families pre-create their single sample so they
            # export a zero value from registration on (standard
            # Prometheus practice: a counter that exists but never fired
            # reads 0, not absent).
            self._init_key(())

    def _init_key(self, key: Tuple[str, ...]) -> None:
        raise NotImplementedError

    def labels(self, **kwargs):
        extra = set(kwargs) - set(self.labelnames)
        if extra:
            raise ValueError(
                f"{self.name}: unknown labels {sorted(extra)} "
                f"(schema: {list(self.labelnames)})")
        key = tuple(str(kwargs.get(l, "")) for l in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                self._init_key(key)
                child = self._children[key]
        return child

    def _sample_items(self) -> List[Tuple[Tuple[str, ...], Any]]:
        with self._lock:
            return list(self._children.items())

    def _label_dict(self, key: Tuple[str, ...]) -> Dict[str, str]:
        d = dict(self.registry.global_labels())
        d.update(zip(self.labelnames, key))
        return d


class _CounterChild(_Child):
    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        self._family._inc(self._key, amount)


class Counter(_Family):
    kind = "counter"

    def __init__(self, registry, name, help, labelnames):
        self._values: Dict[Tuple[str, ...], float] = {}
        super().__init__(registry, name, help, labelnames)

    def _init_key(self, key):
        self._values.setdefault(key, 0.0)
        self._children[key] = _CounterChild(self, key)

    def _inc(self, key, amount):
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def inc(self, amount: float = 1.0) -> None:
        if self.labelnames:
            raise ValueError(f"{self.name}: labeled family needs .labels()")
        self._inc((), amount)

    def samples(self):
        with self._lock:
            return [(self._label_dict(k), v)
                    for k, v in self._values.items()]


class _GaugeChild(_Child):
    __slots__ = ()

    def set(self, value: float) -> None:
        self._family._set(self._key, value)

    def inc(self, amount: float = 1.0) -> None:
        self._family._add(self._key, amount)

    def dec(self, amount: float = 1.0) -> None:
        self._family._add(self._key, -amount)


class Gauge(_Family):
    kind = "gauge"

    def __init__(self, registry, name, help, labelnames):
        self._values: Dict[Tuple[str, ...], float] = {}
        super().__init__(registry, name, help, labelnames)

    def _init_key(self, key):
        self._values.setdefault(key, 0.0)
        self._children[key] = _GaugeChild(self, key)

    def _set(self, key, value):
        with self._lock:
            self._values[key] = float(value)

    def _add(self, key, amount):
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set(self, value: float) -> None:
        if self.labelnames:
            raise ValueError(f"{self.name}: labeled family needs .labels()")
        self._set((), value)

    def inc(self, amount: float = 1.0) -> None:
        if self.labelnames:
            raise ValueError(f"{self.name}: labeled family needs .labels()")
        self._add((), amount)

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def samples(self):
        with self._lock:
            return [(self._label_dict(k), v)
                    for k, v in self._values.items()]


class _HistState:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, nbuckets: int):
        self.counts = [0] * (nbuckets + 1)  # +1 for the +Inf bucket
        self.sum = 0.0
        self.count = 0


class _Timer:
    """Times a with-block into a histogram; while :func:`tracing` held
    when the timer was made, the same span is opened as a
    ``torch.profiler.record_function`` range so it shows up in a
    profiler trace of the card."""

    __slots__ = ("_target", "_annotation", "_t0", "_trace_cm")

    def __init__(self, target, annotation: Optional[str]):
        self._target = target
        self._annotation = annotation
        self._t0 = 0.0
        self._trace_cm = None

    def __enter__(self):
        if self._annotation is not None:
            self._trace_cm = _profiler_annotation(self._annotation)
            if self._trace_cm is not None:
                self._trace_cm.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        elapsed = time.perf_counter() - self._t0
        if self._trace_cm is not None:
            self._trace_cm.__exit__(*exc)
            self._trace_cm = None
        self._target.observe(elapsed)
        return False


class _HistogramChild(_Child):
    __slots__ = ()

    def observe(self, value: float) -> None:
        self._family._observe(self._key, value)

    def time(self, annotation: Optional[str] = None):
        return _Timer(self, _range_name(annotation, self._family.name))


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, registry, name, help, labelnames,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"{name}: histogram needs at least one bucket")
        self._states: Dict[Tuple[str, ...], _HistState] = {}
        super().__init__(registry, name, help, labelnames)

    def _init_key(self, key):
        self._states.setdefault(key, _HistState(len(self.buckets)))
        self._children[key] = _HistogramChild(self, key)

    def _observe(self, key, value):
        value = float(value)
        with self._lock:
            st = self._states[key]
            st.sum += value
            st.count += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    st.counts[i] += 1
                    return
            st.counts[-1] += 1

    def observe(self, value: float) -> None:
        if self.labelnames:
            raise ValueError(f"{self.name}: labeled family needs .labels()")
        self._observe((), value)

    def time(self, annotation: Optional[str] = None):
        if self.labelnames:
            raise ValueError(f"{self.name}: labeled family needs .labels()")
        return _Timer(self, _range_name(annotation, self.name))

    def samples(self):
        out = []
        with self._lock:
            for k, st in self._states.items():
                cum = 0
                bks = {}
                for i, b in enumerate(self.buckets):
                    cum += st.counts[i]
                    bks[format(b, ".12g")] = cum
                bks["+Inf"] = cum + st.counts[-1]
                out.append((self._label_dict(k),
                            {"count": st.count, "sum": st.sum,
                             "buckets": bks}))
        return out


# -- the torch.profiler bridge ----------------------------------------------

def _profiler_annotation(name: str):
    """A ``torch.profiler.record_function`` range, or None when torch is
    unavailable (the bridge must never make metrics a torch
    dependency)."""
    try:
        import torch

        return torch.profiler.record_function(name)
    except Exception:  # noqa: BLE001 - bridge is best-effort
        return None


def tracing() -> bool:
    """Whether spans are recorded now: the bridge's switch is on, or a
    ``torch.profiler`` (``emit_nvtx`` too) records on this thread and
    the threads autograd runs for it. torch is looked up, never
    imported: a process without it records nothing."""
    if registry().trace_bridge:
        return True
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while
    :func:`tracing` holds, else the shared no-op. It shares the device
    trace's clock, and the launches inside it carry their
    ``correlation`` ids. Callers that put numbers in ``name`` build it
    only after :func:`tracing`."""
    if not tracing():
        return _NOOP_TIMER
    cm = _profiler_annotation(name)
    return _NOOP_TIMER if cm is None else cm


def _range_name(annotation: Optional[str], default: str) -> Optional[str]:
    """A timer's range name while :func:`tracing` holds, else None."""
    if not tracing():
        return None
    return default if annotation is None else annotation


def step_annotation(step_num: Optional[int] = None, name: str = "hvd_step"):
    """Context manager for one training step: a
    ``torch.profiler.record_function`` range named ``name#step_num``
    while :func:`tracing` holds (a trace then groups per step), else a
    no-op."""
    if not tracing():
        return _NOOP_TIMER
    return span(name if step_num is None else f"{name}#{step_num}")


# -- registry ---------------------------------------------------------------

class MetricsRegistry:
    """Process-wide family registry + export surfaces.

    ``enabled=None`` reads ``HVD_TPU_METRICS`` (default on); a disabled
    registry returns the :data:`NOOP` singleton from every constructor,
    so instrumentation sites hold no live state at all."""

    def __init__(self, enabled: Optional[bool] = None,
                 trace_bridge: Optional[bool] = None):
        if enabled is None:
            enabled = _truthy(runtime_env("METRICS"), True)
        if trace_bridge is None:
            trace_bridge = _truthy(runtime_env("METRICS_TRACE"), False)
        self.enabled = bool(enabled)
        self.trace_bridge = bool(trace_bridge) and self.enabled
        self._lock = lockdep.lock("metrics.registry")
        self._families: Dict[str, _Family] = {}
        self._global_labels: Dict[str, str] = {}

    # -- registration -------------------------------------------------------

    def _get(self, cls, name: str, help: str, labels: Sequence[str],
             **kwargs):
        if not self.enabled:
            return NOOP
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = cls(self, name, help, labels, **kwargs)
                self._families[name] = fam
            elif not isinstance(fam, cls) or \
                    fam.labelnames != tuple(labels):
                raise ValueError(
                    f"metric {name} already registered as {fam.kind} with "
                    f"labels {fam.labelnames}")
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    # -- global labels (rank identity for pod aggregation) ------------------

    def set_global_labels(self, **labels: str) -> None:
        with self._lock:
            for k, v in labels.items():
                if not _LABEL_RE.match(k):
                    raise ValueError(f"invalid label name: {k!r}")
                self._global_labels[k] = str(v)

    def global_labels(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._global_labels)

    # -- export surfaces ----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able dict of every family: the ``hvd.metrics()`` view."""
        with self._lock:
            fams = list(self._families.values())
        out: Dict[str, Any] = {}
        for fam in fams:
            out[fam.name] = {
                "type": fam.kind,
                "help": fam.help,
                "samples": [{"labels": lbls, "value": v}
                            for lbls, v in fam.samples()],
            }
        return out

    def prometheus_text(self) -> str:
        """Prometheus exposition text format 0.0.4."""
        with self._lock:
            fams = list(self._families.values())
        lines: List[str] = []
        for fam in fams:
            if fam.help:
                lines.append(f"# HELP {fam.name} "
                             + fam.help.replace("\\", "\\\\")
                             .replace("\n", "\\n"))
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for lbls, v in fam.samples():
                if fam.kind == "histogram":
                    for le, c in v["buckets"].items():
                        lines.append(_sample_line(
                            fam.name + "_bucket", {**lbls, "le": le}, c))
                    lines.append(_sample_line(fam.name + "_sum", lbls,
                                              v["sum"]))
                    lines.append(_sample_line(fam.name + "_count", lbls,
                                              v["count"]))
                else:
                    lines.append(_sample_line(fam.name, lbls, v))
        return "\n".join(lines) + "\n"


def _sample_line(name: str, labels: Dict[str, str], value: float) -> str:
    if labels:
        body = ",".join(f'{k}="{_escape_label(str(v))}"'
                        for k, v in sorted(labels.items()))
        return f"{name}{{{body}}} {_fmt_value(float(value))}"
    return f"{name} {_fmt_value(float(value))}"


# -- module-level singleton + convenience API -------------------------------

_registry: Optional[MetricsRegistry] = None
_registry_lock = lockdep.lock("metrics.module")


def registry() -> MetricsRegistry:
    """The process-wide registry (created on first use from env)."""
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = MetricsRegistry()
    return _registry


def enabled() -> bool:
    return registry().enabled


def counter(name: str, help: str = "", labels: Sequence[str] = ()):
    return registry().counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()):
    return registry().gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS):
    return registry().histogram(name, help, labels, buckets=buckets)


def set_global_labels(**labels: str) -> None:
    if registry().enabled:
        registry().set_global_labels(**labels)


def enable_trace_bridge(on: bool = True) -> None:
    """Turn the torch.profiler bridge on/off at runtime (also:
    HVD_TPU_METRICS_TRACE=1): spans then open their ranges with no
    profiler running too. No-op on a disabled registry; a running
    profiler still sees the spans."""
    reg = registry()
    reg.trace_bridge = bool(on) and reg.enabled


def snapshot() -> Dict[str, Any]:
    return registry().snapshot()


def metrics() -> Dict[str, Any]:
    """Every registered family as a JSON-able dict (``hvd.metrics()``)."""
    return registry().snapshot()


def prometheus_text() -> str:
    return registry().prometheus_text()


# -- export surface 2: JSON-lines dump (timeline writer-thread pattern) -----

class MetricsDumper:
    """Appends one ``{"t": ..., "metrics": snapshot}`` JSON line per
    interval from a daemon writer thread — the ``common/timeline.py``
    pattern: the hot path never touches the file; stop() drains with a
    final dump so the tail state is never lost."""

    def __init__(self, path: str, interval_s: float = 10.0,
                 reg: Optional[MetricsRegistry] = None):
        self.path = path
        self.interval_s = max(float(interval_s), 0.05)
        self._reg = reg
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _registry(self) -> MetricsRegistry:
        return self._reg if self._reg is not None else registry()

    def start(self) -> "MetricsDumper":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="hvd-tpu-metrics-dump")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._dump()

    def _dump(self) -> None:
        try:
            line = json.dumps({"t": time.time(),
                               "metrics": self._registry().snapshot()})
            with open(self.path, "a") as f:
                f.write(line + "\n")
        except (OSError, TypeError, ValueError):  # best-effort, never fatal
            pass

    def stop(self) -> None:
        """Idempotent; the final dump runs even if start() raced stop()."""
        if self._thread is None:
            return
        self._stop.set()
        t, self._thread = self._thread, None
        t.join(timeout=5.0)
        self._dump()  # drain-on-stop: final state always lands on disk


_dumper: Optional[MetricsDumper] = None


def start_file_dump(path: str, interval_s: float = 10.0) -> MetricsDumper:
    """Start (or return) the process-wide JSON-lines dumper."""
    global _dumper
    with _registry_lock:
        if _dumper is None:
            _dumper = MetricsDumper(path, interval_s).start()
        return _dumper


def dumping_path() -> Optional[str]:
    with _registry_lock:
        return _dumper.path if _dumper is not None else None


def stop_file_dump() -> None:
    global _dumper
    with _registry_lock:
        d, _dumper = _dumper, None
    if d is not None:
        d.stop()


# -- export surface 3: Prometheus /metrics endpoint -------------------------

class MetricsServer:
    """``/metrics`` (Prometheus text) + ``/metrics.json`` (snapshot) on a
    background ``ThreadingHTTPServer`` (``common/httpd.py``, the same
    plumbing the rendezvous KV server rides)."""

    def __init__(self, reg: Optional[MetricsRegistry] = None,
                 host: str = "0.0.0.0"):
        from .httpd import BackgroundHTTPServer

        self._reg = reg
        self._http = BackgroundHTTPServer(_metrics_handler_cls(), host=host)

    def start(self, port: int = 0,
              debug: Optional[bool] = None) -> int:
        if debug is None:
            debug = _truthy(runtime_env("METRICS_DEBUG"), False)
        return self._http.start(
            port,
            metrics_registry=(self._reg if self._reg is not None
                              else registry()),
            debug_enabled=bool(debug))

    @property
    def port(self) -> int:
        return self._http.port

    def stop(self) -> None:
        self._http.stop()


_handler_cls = None


def _metrics_handler_cls():
    """The BaseHTTPRequestHandler subclass, built lazily so importing
    this module never touches http.server."""
    global _handler_cls
    if _handler_cls is not None:
        return _handler_cls
    from http.server import BaseHTTPRequestHandler

    class _MetricsHandler(BaseHTTPRequestHandler):
        server_version = "HvdTpuMetrics/0.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _unavailable(self, why: str) -> None:
            # 503 with a one-line reason: a disabled debug surface
            # answers cleanly instead of 404-ing (the operator can tell
            # "off" from "wrong URL").
            self._send(503, (why + "\n").encode(),
                       "text/plain; charset=utf-8")

        def do_GET(self):
            from urllib.parse import parse_qs, urlparse

            reg = self.server.metrics_registry  # type: ignore[attr-defined]
            parsed = urlparse(self.path)
            path = parsed.path
            if path in ("/", "/metrics"):
                self._send(200, reg.prometheus_text().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/metrics.json":
                self._send(200, json.dumps(reg.snapshot()).encode(),
                           "application/json")
            elif path == "/debug/stacks":
                # On-demand all-thread dump: the remote analog of a
                # SIGUSR2 black box — "what is this rank doing RIGHT
                # NOW" without a shell on its host.
                if not getattr(self.server, "debug_enabled", False):
                    return self._unavailable(
                        "debug endpoints disabled "
                        "(HVD_TPU_METRICS_DEBUG=1 enables)")
                self._send(200, _thread_stacks_text().encode(),
                           "text/plain; charset=utf-8")
            elif path == "/debug/profile":
                if not getattr(self.server, "debug_enabled", False):
                    return self._unavailable(
                        "debug endpoints disabled "
                        "(HVD_TPU_METRICS_DEBUG=1 enables)")
                qs = parse_qs(parsed.query)
                try:
                    ms = int(qs.get("ms", ["1000"])[0])
                except ValueError:
                    ms = 1000
                ms = max(1, min(ms, PROFILE_MS_CAP))
                target = qs.get("dir", [None])[0]
                ok, payload = _capture_profile(target, ms)
                if not ok:
                    return self._unavailable(payload)
                self._send(200, json.dumps(payload).encode(),
                           "application/json")
            else:
                self.send_response(404)
                self.end_headers()

    _handler_cls = _MetricsHandler
    return _MetricsHandler


def thread_stacks() -> Dict[str, List[str]]:
    """All-thread Python stacks keyed ``"<name>:<tid>"`` — the one
    collector behind both /debug/stacks and the flight recorder's
    black-box ``stacks`` payload (the two views must not drift)."""
    import sys
    import traceback

    names = {t.ident: t.name for t in threading.enumerate()}
    return {f"{names.get(tid, '?')}:{tid}": traceback.format_stack(frame)
            for tid, frame in sys._current_frames().items()}


def _thread_stacks_text() -> str:
    chunks = []
    for label, stack in thread_stacks().items():
        name, _, tid = label.rpartition(":")
        chunks.append(f"--- thread {name} ({tid}) ---\n" + "".join(stack))
    return "\n".join(chunks)


_profile_lock = lockdep.lock("metrics.profile")


def _capture_profile(target: Optional[str], ms: int):
    """Bounded ``torch.profiler`` capture for /debug/profile: CPU
    activities, and CUDA ones when a card is present, for ``ms``
    milliseconds; the Chrome trace is written to ``target`` (a fresh
    temporary directory when None) and returned. Returns ``(ok,
    payload_or_reason)``. 503 reasons: torch unavailable, another
    capture already running (one at a time — two profilers at once
    fail), or a start failure. The handler thread only sleeps and
    reads: it issues no collective and waits on no training work."""
    if not _profile_lock.acquire(blocking=False):
        return False, "a profiler capture is already in progress"
    try:
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
        except Exception as e:  # noqa: BLE001 — torch-less processes
            return False, f"torch.profiler unavailable ({e})"
        if target is None:
            import tempfile

            target = tempfile.mkdtemp(prefix="hvd_tpu_profile_")
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        try:
            prof.__enter__()
        except Exception as e:  # noqa: BLE001 — never kill the server
            return False, f"profiler start failed ({e})"
        try:
            time.sleep(ms / 1000.0)
        finally:
            try:
                prof.__exit__(None, None, None)
            except Exception as e:  # noqa: BLE001
                return False, f"profiler stop failed ({e})"
        path = os.path.join(target, "trace.json")
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        except (OSError, ValueError) as e:
            return False, f"profiler trace export failed ({e})"
        return True, {"dir": target, "ms": ms, "file": path,
                      "trace": trace}
    finally:
        _profile_lock.release()


_server: Optional[MetricsServer] = None


def serve(port: int = 0, host: str = "0.0.0.0") -> int:
    """Start (or return) the process-wide endpoint; returns the bound
    port (``port=0`` binds an ephemeral one)."""
    global _server
    with _registry_lock:
        if _server is None:
            s = MetricsServer(host=host)
            s.start(port)
            _server = s
        return _server.port


def serving_port() -> Optional[int]:
    with _registry_lock:
        return _server.port if _server is not None else None


def stop_serving() -> None:
    global _server
    with _registry_lock:
        s, _server = _server, None
    if s is not None:
        s.stop()
