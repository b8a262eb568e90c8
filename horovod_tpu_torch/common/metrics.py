"""The process-wide metrics registry of the port.

The port's copy of the registry in ``horovod_tpu/common/metrics.py``:
counters, gauges and fixed-bucket histograms with Prometheus-style
labels, registered by name (one family per name, process-wide), read
back through :func:`metrics` (the ``hvd.metrics()`` dict). The serve
modules register their ``hvd_tpu_serve_*`` families here under the same
names and labels as the JAX package.

With ``HVD_TPU_METRICS=0`` every constructor returns the shared
:data:`NOOP` singleton, so instrumented hot paths allocate nothing.
The JAX package's profiler bridge, global rank labels, Prometheus text
export, file dumper and HTTP endpoint are not part of this copy.
"""

from __future__ import annotations

import re
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

from .config import runtime_env

DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _truthy(raw: Optional[str], default: bool) -> bool:
    if raw is None:
        return default
    return raw.strip().lower() not in ("0", "false", "no", "off", "")


class NoopMetric:
    """Universal no-op stand-in for every metric type of a disabled
    registry."""

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


NOOP = NoopMetric()


class _Child:
    """One labeled sample of a family."""

    __slots__ = ("_family", "_key")

    def __init__(self, family: "_Family", key: Tuple[str, ...]):
        self._family = family
        self._key = key


class _Family:
    """A name + label schema + per-label-set state; one lock per family
    serializes child creation and updates."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: Sequence[str]):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name: {name!r}")
        for label in labelnames:
            if not _LABEL_RE.match(label):
                raise ValueError(f"invalid label name: {label!r}")
        self.registry = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}
        if not self.labelnames:
            # An unlabeled family exports 0 from registration on.
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

    def _label_dict(self, key: Tuple[str, ...]) -> Dict[str, str]:
        return dict(zip(self.labelnames, key))

    def _unlabeled(self) -> None:
        if self.labelnames:
            raise ValueError(f"{self.name}: labeled family needs .labels()")


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
        self._unlabeled()
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
        self._unlabeled()
        self._set((), value)

    def inc(self, amount: float = 1.0) -> None:
        self._unlabeled()
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


class _HistogramChild(_Child):
    __slots__ = ()

    def observe(self, value: float) -> None:
        self._family._observe(self._key, value)


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
        self._unlabeled()
        self._observe((), value)

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


class MetricsRegistry:
    """Process-wide family registry. ``enabled=None`` reads
    ``HVD_TPU_METRICS`` (default on); a disabled registry returns
    :data:`NOOP` from every constructor."""

    def __init__(self, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = _truthy(runtime_env("METRICS"), True)
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

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

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able dict of every family."""
        with self._lock:
            fams = list(self._families.values())
        return {fam.name: {"type": fam.kind, "help": fam.help,
                           "samples": [{"labels": lbls, "value": v}
                                       for lbls, v in fam.samples()]}
                for fam in fams}


_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()


def registry() -> MetricsRegistry:
    """The process-wide registry (created on first use from env)."""
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = MetricsRegistry()
    return _registry


def counter(name: str, help: str = "", labels: Sequence[str] = ()):
    return registry().counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()):
    return registry().gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS):
    return registry().histogram(name, help, labels, buckets=buckets)


def metrics() -> Dict[str, Any]:
    """Every registered family as a JSON-able dict (``hvd.metrics()``)."""
    return registry().snapshot()

