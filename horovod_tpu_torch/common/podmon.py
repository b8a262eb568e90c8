"""Pod-scope metrics aggregation — the elastic driver's scrape plane;
the port's copy of ``horovod_tpu/common/podmon.py``.

Every worker serves its own ``/metrics``; the questions that matter at
pod scale ("what is the step skew across the pod?", "which rank is
slowest?") need MERGED cross-rank views. So this module runs a
background scraper in the DRIVER process that:

* discovers every rank's ``/metrics.json`` endpoint — workers advertise
  ``host:port`` over the rendezvous KV at init
  (:func:`register_endpoint`), and endpoints outside the KV can be
  listed statically in ``HVD_TPU_POD_METRICS_ENDPOINTS``
  ("host:port,host:port");
* polls them every ``HVD_TPU_POD_METRICS_INTERVAL_S`` seconds (default
  2 s) and keeps the freshest per-rank snapshot;
* merges them into pod-level series — every scraped sample re-served
  with its ``rank=`` label, plus ``hvd_tpu_pod_step_skew_seconds``
  (max − min of per-rank step time), ``hvd_tpu_pod_slowest_rank``,
  per-family min/max/p50 (``hvd_tpu_pod_stat{family=,stat=}``) and
  scrape health — on ONE endpoint, ``/pod/metrics`` (and
  ``/pod/metrics.json``), through ``common/httpd.py``;
* hands the merged snapshots to the
  :class:`~.autoscale.AutoscaleEngine` as a second signal source
  (:func:`scrape_report_fetcher` / :func:`merged_report_fetcher`).

Enable with ``hvdtpurun-torch --pod-metrics-port N``
(``HVD_TPU_POD_METRICS_PORT``; 0 = ephemeral). Role-grouped views need a
hybrid ParallelSpec, which comes with the parallel-roles slice of the
port: asking for one raises. Stdlib-only at import.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import lockdep
from . import metrics as metrics_lib
from .config import runtime_env

logger = logging.getLogger("horovod_tpu_torch")

ENV_PORT = "HVD_TPU_POD_METRICS_PORT"
ENV_INTERVAL = "HVD_TPU_POD_METRICS_INTERVAL_S"
ENV_ENDPOINTS = "HVD_TPU_POD_METRICS_ENDPOINTS"
ENV_ADVERTISE = "HVD_TPU_METRICS_ADVERTISE"
_ROLES_SLICE = "the parallel-roles slice"

KV_SCOPE = "podmon"                 # rendezvous KV scope for endpoints

# Names of the computed pod-level families (the JAX package's).
POD_SKEW = "hvd_tpu_pod_step_skew_seconds"
POD_SLOWEST = "hvd_tpu_pod_slowest_rank"
POD_STEP_TIME = "hvd_tpu_pod_step_time_seconds"
POD_RANKS = "hvd_tpu_pod_ranks_scraped"
POD_ERRORS = "hvd_tpu_pod_scrape_errors_total"
POD_STAT = "hvd_tpu_pod_stat"


# -- worker side: endpoint advertisement -------------------------------------

def register_endpoint(port: int, rank: Optional[int] = None) -> bool:
    """Advertise this worker's metrics endpoint over the controller KV
    (``podmon/endpoint.<rank>``) so the driver-side aggregator can
    scrape it without knowing ephemeral ports. Best-effort: no
    retries, short timeout, False on any failure. No-op without
    ``HVD_TPU_RENDEZVOUS``."""
    rdv = runtime_env("RENDEZVOUS")
    if not rdv:
        return False
    # HVD_TPU_PROC_ID (the launcher's identity of this worker) wins;
    # the caller's rank is the fallback.
    env_rank = runtime_env("PROC_ID")
    if env_rank is not None:
        try:
            rank = int(env_rank)
        except ValueError:
            pass
    if rank is None:
        rank = 0
    addr = runtime_env("METRICS_ADVERTISE")
    if not addr:
        # Named local hosts (hostA, hostB, ...) are not resolvable;
        # anything the launcher forked locally is reachable on loopback.
        host = runtime_env("HOSTNAME", "")
        if not host or runtime_env("ELASTIC_FORCE_LOCAL"):
            host = "127.0.0.1"
        addr = host
    record = {"rank": int(rank),
              "host": runtime_env("HOSTNAME", ""),
              "addr": f"{addr}:{int(port)}"}
    try:
        from ..runner.rendezvous import RendezvousClient

        kv_host, kv_port = rdv.rsplit(":", 1)
        client = RendezvousClient(kv_host, int(kv_port), timeout_s=2.0,
                                  retries=0)
        client.put(KV_SCOPE, f"endpoint.{rank}",
                   json.dumps(record).encode())
        return True
    except Exception as e:  # noqa: BLE001 — advertisement is best-effort
        logger.debug("podmon: endpoint registration failed (%s)", e)
        return False


# -- endpoint discovery -------------------------------------------------------

def kv_endpoints(rdv_server) -> Callable[[], List[str]]:
    """Driver-side endpoint source over the in-process rendezvous KV
    (the elastic driver owns the server)."""

    def endpoints() -> List[str]:
        out: List[str] = []
        for key, raw in rdv_server.scope_items(KV_SCOPE).items():
            if not key.startswith("endpoint."):
                continue
            try:
                rec = json.loads(raw.decode())
                out.append(str(rec["addr"]))
            except (ValueError, KeyError, UnicodeDecodeError):
                continue
        return sorted(set(out))

    return endpoints


def static_endpoints(spec: Optional[str] = None) -> Callable[[], List[str]]:
    """Fixed ``host:port,host:port`` list (``HVD_TPU_POD_METRICS_ENDPOINTS``
    — endpoints that never touch this job's KV)."""
    if spec is None:
        spec = runtime_env("POD_METRICS_ENDPOINTS", "")
    fixed = [e.strip() for e in spec.split(",") if e.strip()]

    def endpoints() -> List[str]:
        return list(fixed)

    return endpoints


def combined_endpoints(*sources: Callable[[], List[str]]
                       ) -> Callable[[], List[str]]:
    def endpoints() -> List[str]:
        out: List[str] = []
        for src in sources:
            try:
                out.extend(src())
            except Exception:  # noqa: BLE001 — one dead source is fine
                pass
        return sorted(set(out))

    return endpoints


# -- snapshot plumbing --------------------------------------------------------

def _sample_value(snapshot: Dict[str, Any], family: str,
                  **labels: str) -> Optional[float]:
    """First matching scalar sample of a family in a /metrics.json
    snapshot (None for histograms / missing)."""
    fam = snapshot.get(family)
    if not fam:
        return None
    for s in fam.get("samples", ()):
        if all(str(s.get("labels", {}).get(k)) == str(v)
               for k, v in labels.items()):
            v = s.get("value")
            if isinstance(v, (int, float)):
                return float(v)
    return None


def _hist_totals(snapshot: Dict[str, Any], family: str
                 ) -> Tuple[float, float]:
    """(sum, count) across every sample of a histogram family."""
    fam = snapshot.get(family)
    total = count = 0.0
    if fam:
        for s in fam.get("samples", ()):
            v = s.get("value")
            if isinstance(v, dict):
                total += float(v.get("sum", 0.0))
                count += float(v.get("count", 0.0))
    return total, count


def _snapshot_identity(snapshot: Dict[str, Any]
                       ) -> Tuple[Optional[int], str]:
    """(rank, host) from the global labels any sample carries."""
    for fam in snapshot.values():
        for s in fam.get("samples", ()):
            labels = s.get("labels", {})
            if "rank" in labels:
                try:
                    return int(labels["rank"]), str(labels.get("host", ""))
                except (TypeError, ValueError):
                    return None, str(labels.get("host", ""))
    return None, ""


def step_time_from_snapshot(snapshot: Dict[str, Any]) -> Optional[float]:
    """Best per-rank step-time estimate a scrape can give: the
    autoscale publisher's rolling p50 when the worker runs one, else
    the mean of the optimizer's step histogram, else the mean of the
    eager collective-latency histogram (a weak proxy, but monotone in
    'this rank is slow')."""
    v = _sample_value(snapshot, "hvd_tpu_autoscale_step_time_seconds")
    if v is not None and v > 0:
        return v
    for fam in ("hvd_tpu_step_seconds", "hvd_tpu_collective_seconds"):
        total, count = _hist_totals(snapshot, fam)
        if count > 0:
            return total / count
    return None


def step_count_from_snapshot(snapshot: Dict[str, Any]) -> int:
    """An advancing per-rank step counter: the autoscale publisher's
    commit counter when present, else the step histogram's count, else
    the collective-latency count (any monotone activity counter lets
    the engine's advancement tracking work)."""
    v = _sample_value(snapshot, "hvd_tpu_autoscale_steps_total")
    if v is not None and v > 0:
        return int(v)
    for fam in ("hvd_tpu_step_seconds", "hvd_tpu_collective_seconds"):
        _, count = _hist_totals(snapshot, fam)
        if count > 0:
            return int(count)
    return 0


class PodMonitor:
    """Background scraper + pod-level aggregator + /pod/metrics server.

    ``endpoints_fn`` returns the current ``host:port`` list;
    ``clock``/``urlopen`` are injectable for deterministic tests."""

    def __init__(self, endpoints_fn: Callable[[], List[str]],
                 interval_s: Optional[float] = None,
                 timeout_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic,
                 parallel=None):
        self._endpoints = endpoints_fn
        if parallel is not None or runtime_env("PARALLEL"):
            raise NotImplementedError(
                "role-grouped pod views (a hybrid ParallelSpec) are not "
                f"ported yet; they come with {_ROLES_SLICE} of the port")
        self.parallel = None
        if interval_s is None:
            try:
                interval_s = float(runtime_env("POD_METRICS_INTERVAL_S", "2.0"))
            except ValueError:
                interval_s = 2.0
        self.interval_s = max(0.05, float(interval_s))
        self.timeout_s = timeout_s
        self._clock = clock
        self._lock = lockdep.lock("podmon.scrapes")
        # rank -> {"snapshot": dict, "t": clock(), "endpoint": str}
        self._ranks: Dict[int, Dict[str, Any]] = {}
        self._fails: Dict[str, int] = {}    # endpoint -> consecutive misses
        self._scrapes = 0
        self._errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._http = None
        self.port: Optional[int] = None

    # -- scraping -----------------------------------------------------------

    def _fetch(self, endpoint: str) -> Optional[Dict[str, Any]]:
        import urllib.request

        try:
            with urllib.request.urlopen(
                    f"http://{endpoint}/metrics.json",
                    timeout=self.timeout_s) as resp:
                return json.loads(resp.read().decode())
        except Exception:  # noqa: BLE001 — a dead rank is the normal case
            return None

    # Consecutive failed scrapes after which an endpoint's last
    # snapshot is dropped from the pod view: a dead/evicted rank must
    # not inflate skew, slowest-rank attribution, or the autoscale
    # bridge forever. (One miss is the normal restart case — elastic
    # workers vanish for a beat mid-reset.)
    STALE_SCRAPES = 3

    def scrape_once(self) -> int:
        """Poll every endpoint once; returns the number of ranks with a
        fresh snapshot."""
        fresh = 0
        # One capture per pass: the KV-backed endpoint list can change
        # between calls (elastic startup), and both the pre-init
        # pseudo-rank key and the eviction sweep must see ONE view.
        endpoints = self._endpoints()
        for idx, endpoint in enumerate(endpoints):
            snap = self._fetch(endpoint)
            if snap is None:
                with self._lock:
                    self._errors += 1
                    misses = self._fails.get(endpoint, 0) + 1
                    self._fails[endpoint] = misses
                    if misses >= self.STALE_SCRAPES:
                        for r, rec in list(self._ranks.items()):
                            if rec.get("endpoint") == endpoint:
                                del self._ranks[r]
                continue
            rank, host = _snapshot_identity(snap)
            if rank is None:
                # Pre-init worker (no rank label yet): key by position
                # in this pass's list so the series still shows up.
                rank = -1 - idx
            with self._lock:
                self._fails.pop(endpoint, None)
                # One entry per endpoint: a pre-init pseudo-rank that
                # since gained its real identity (or got re-keyed by a
                # shifted position) must not linger as a stale twin.
                for r, rec in list(self._ranks.items()):
                    if r != rank and rec.get("endpoint") == endpoint:
                        del self._ranks[r]
                self._ranks[rank] = {"snapshot": snap, "host": host,
                                     "t": self._clock(),
                                     "endpoint": endpoint}
            fresh += 1
        with self._lock:
            self._scrapes += 1
        return fresh

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 — the scraper must survive
                logger.exception("podmon: scrape failed")

    def start(self, port: Optional[int] = None) -> Optional[int]:
        """Start the scrape thread; with ``port`` also serve
        ``/pod/metrics`` there (0 = ephemeral). Returns the bound port
        (or None when serving was not requested)."""
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="hvd-tpu-podmon")
            self._thread.start()
        if port is not None and self._http is None:
            from .httpd import BackgroundHTTPServer

            self._http = BackgroundHTTPServer(_pod_handler_cls())
            self.port = self._http.start(port, pod_monitor=self)
            logger.info("podmon: /pod/metrics endpoint on port %d",
                        self.port)
        return self.port

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        if self._http is not None:
            self._http.stop()
            self._http = None

    # -- aggregation --------------------------------------------------------

    def rank_snapshots(self) -> Dict[int, Dict[str, Any]]:
        with self._lock:
            return {r: dict(v) for r, v in self._ranks.items()}

    def merged(self) -> Dict[str, Any]:
        """The pod view: per-rank step times, skew, slowest-rank
        attribution, per-family min/max/p50 summaries, scrape health,
        and the raw rank-labeled pass-through families."""
        with self._lock:
            ranks = {r: dict(v) for r, v in self._ranks.items()}
            scrapes, errors = self._scrapes, self._errors
        step_times: Dict[int, float] = {}
        for r, rec in ranks.items():
            st = step_time_from_snapshot(rec["snapshot"])
            if st is not None:
                step_times[r] = st
        skew = (max(step_times.values()) - min(step_times.values())
                if len(step_times) >= 2 else 0.0)
        slowest = (max(step_times, key=step_times.get)
                   if step_times else None)
        # min/max/p50 per scalar family across ranks (rank-labeled
        # families collapse to their per-rank first sample).
        stats: Dict[str, Dict[str, float]] = {}
        per_family: Dict[str, List[float]] = {}
        for rec in ranks.values():
            for fname, fam in rec["snapshot"].items():
                if fam.get("type") not in ("counter", "gauge"):
                    continue
                total = 0.0
                seen = False
                for s in fam.get("samples", ()):
                    v = s.get("value")
                    if isinstance(v, (int, float)):
                        total += float(v)
                        seen = True
                if seen:
                    per_family.setdefault(fname, []).append(total)
        for fname, vals in per_family.items():
            stats[fname] = {"min": min(vals), "max": max(vals),
                            "p50": statistics.median(vals)}
        # The role view (rank -> (dp,pp,tp), replica medians, stalled
        # replicas) needs a hybrid spec: empty, as in the JAX monitor
        # without one.
        roles: Dict[int, str] = {}
        coords: Dict[int, Dict[str, int]] = {}
        replica_step: Dict[int, float] = {}
        stalled: List[int] = []
        return {
            "ranks": sorted(ranks),
            "hosts": {r: rec.get("host", "") for r, rec in ranks.items()},
            "step_time_seconds": step_times,
            "step_skew_seconds": skew,
            "slowest_rank": slowest,
            "roles": roles,
            "role_coords": coords,
            "replica_step_time_seconds": replica_step,
            "stalled_replicas": stalled,
            "family_stats": stats,
            "scrapes": scrapes,
            "scrape_errors": errors,
            "snapshots": {r: rec["snapshot"] for r, rec in ranks.items()},
        }

    def serve_view(self) -> Dict[str, Any]:
        """The /pod/serve aggregation: this process's request span
        ledger — per-role p50/p99 over queue-wait / handoff / decode
        spans, slowest-request exemplars with their span breakdowns,
        the pod goodput fraction — plus the scraped ``hvd_tpu_serve_*``
        family stats across ranks."""
        from ..serve import tracing
        view = tracing.tracer().pod_view()
        m = self.merged()
        view["serve_family_stats"] = {
            f: d for f, d in sorted(m["family_stats"].items())
            if f.startswith("hvd_tpu_serve_")}
        view["scrapes"] = m["scrapes"]
        view["scrape_errors"] = m["scrape_errors"]
        return view

    def serve_text(self) -> str:
        """/pod/serve's human form: one fact per line."""
        v = self.serve_view()
        lines = [
            f"tracing_enabled {v['enabled']}",
            f"requests {v['requests']}",
            f"spans {v['spans']}",
            f"orphans {v['orphans']}",
            # Overload control: the brownout ladder level and the typed
            # terminal outcomes, so "is the cluster browning out and
            # what is it costing" reads off one endpoint.
            f"brownout_level {v['brownout_level']}",
            f"shed {v['shed']}",
            f"rejected {v['rejected']}",
            f"goodput_fraction {v['goodput_fraction']}",
        ]
        for role, row in sorted(v["roles"].items()):
            for metric, val in sorted(row.items()):
                lines.append(f"role {role} {metric} {val}")
        for rep, per in sorted(v["goodput"].items()):
            for state, secs in sorted(per.items()):
                lines.append(f"goodput {rep} {state} {secs}")
        for ex in v["slowest"]:
            phases = " ".join(
                f"{s['phase']}={round(s['t1'] - s['t0'], 6)}"
                for s in ex["spans"])
            lines.append(f"slowest rid={ex['rid']} "
                         f"total={ex['total_s']} {phases}")
        return "\n".join(lines) + "\n"

    def prometheus_text(self) -> str:
        """The merged pod view in Prometheus exposition format:
        computed pod families first, then every scraped sample
        re-served verbatim (each already carries its ``rank=`` label)."""
        m = self.merged()
        lines: List[str] = []

        def emit(name, kind, help_, samples):
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            for labels, value in samples:
                lines.append(metrics_lib._sample_line(name, labels, value))

        def rank_labels(r):
            return {"rank": str(r), "host": m["hosts"].get(r, "")}

        emit(POD_STEP_TIME, "gauge",
             "per-rank step time as seen by the pod aggregator",
             [(rank_labels(r), v)
              for r, v in sorted(m["step_time_seconds"].items())])
        emit(POD_SKEW, "gauge",
             "max-min spread of per-rank step time across the pod",
             [({}, m["step_skew_seconds"])])
        if m["slowest_rank"] is not None:
            emit(POD_SLOWEST, "gauge",
                 "rank id with the highest step time (straggler "
                 "attribution)", [({}, float(m["slowest_rank"]))])
        emit(POD_RANKS, "gauge",
             "ranks with a fresh snapshot on the last scrape",
             [({}, float(len(m["ranks"])))])
        emit(POD_ERRORS, "counter",
             "scrape attempts that failed", [({}, float(m["scrape_errors"]))])
        emit(POD_STAT, "gauge",
             "pod-level min/max/p50 of each scalar family across ranks",
             [({"family": f, "stat": st}, v)
              for f, d in sorted(m["family_stats"].items())
              for st, v in sorted(d.items())])
        # Pass-through: every rank's samples, already rank-labeled.
        served: set = set()
        for r in sorted(m["snapshots"]):
            snap = m["snapshots"][r]
            for fname in sorted(snap):
                fam = snap[fname]
                if fam.get("type") == "histogram":
                    continue  # summaries above; raw buckets stay per-rank
                if fname not in served:
                    served.add(fname)
                    lines.append(f"# TYPE {fname} {fam.get('type', 'untyped')}")
                for s in fam.get("samples", ()):
                    v = s.get("value")
                    if isinstance(v, (int, float)):
                        lines.append(metrics_lib._sample_line(
                            fname, s.get("labels", {}), v))
        return "\n".join(lines) + "\n"

    # -- the autoscale bridge ------------------------------------------------

    def reports(self) -> Dict[int, Any]:
        """Scrape-derived ``{rank: StepReport}`` — the second signal
        source of :class:`~.autoscale.AutoscaleEngine`, covering ranks
        that never publish to the KV."""
        from .autoscale import StepReport

        out: Dict[int, Any] = {}
        for r, rec in self.rank_snapshots().items():
            if r < 0:
                continue  # identity-less pre-init scrape
            snap = rec["snapshot"]
            p50 = step_time_from_snapshot(snap)
            if p50 is None:
                continue
            resyncs = _sample_value(snap, "hvd_tpu_recovery_total",
                                    counter="divergence_resyncs") or 0
            comm = total = 0.0
            fam = snap.get("hvd_tpu_step_phase_seconds")
            if fam:
                for s in fam.get("samples", ()):
                    v = s.get("value")
                    if isinstance(v, dict):
                        total += float(v.get("sum", 0.0))
                        if s.get("labels", {}).get("phase") == "comm":
                            comm += float(v.get("sum", 0.0))
            role = None
            out[r] = StepReport(
                rank=r, host=rec.get("host", ""),
                step=step_count_from_snapshot(snap),
                n=1, p50=float(p50), mean=float(p50), last=float(p50),
                comm_fraction=(comm / total if total > 0 else None),
                resyncs=int(resyncs), t=rec.get("t", 0.0), role=role)
        return out


def scrape_report_fetcher(monitor: PodMonitor
                          ) -> Callable[[], Dict[int, Any]]:
    return monitor.reports


def merged_report_fetcher(kv_fetch: Callable[[], Dict[int, Any]],
                          monitor: PodMonitor
                          ) -> Callable[[], Dict[int, Any]]:
    """KV reports win per rank (they carry real rolling windows); the
    scrape path fills in ranks the KV has never heard from."""

    def fetch() -> Dict[int, Any]:
        out = monitor.reports()
        out.update(kv_fetch())
        return out

    return fetch


# -- the /pod/metrics handler -------------------------------------------------

_pod_handler = None


def _pod_handler_cls():
    global _pod_handler
    if _pod_handler is not None:
        return _pod_handler
    from http.server import BaseHTTPRequestHandler

    class _PodHandler(BaseHTTPRequestHandler):
        server_version = "HvdTpuPodMon/0.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def do_GET(self):
            from urllib.parse import urlparse

            mon = self.server.pod_monitor  # type: ignore[attr-defined]
            path = urlparse(self.path).path
            if path in ("/", "/pod/metrics", "/metrics"):
                body = mon.prometheus_text().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path in ("/pod/metrics.json", "/metrics.json"):
                merged = mon.merged()
                merged.pop("snapshots", None)  # keep the JSON view lean
                body = json.dumps(merged).encode()
                ctype = "application/json"
            elif path == "/pod/serve":
                body = mon.serve_text().encode()
                ctype = "text/plain; charset=utf-8"
            elif path == "/pod/serve.json":
                body = json.dumps(mon.serve_view()).encode()
                ctype = "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    _pod_handler = _PodHandler
    return _PodHandler


def monitor_port_from_env(env=None) -> Optional[int]:
    """The requested /pod/metrics port, or None when pod aggregation is
    off (the launcher exports HVD_TPU_POD_METRICS_PORT; negative
    disables, 0 = ephemeral)."""
    env = os.environ if env is None else env
    raw = env.get(ENV_PORT)
    if raw is None or raw.strip() == "":
        return None
    try:
        port = int(raw)
    except ValueError:
        return None
    return port if port >= 0 else None
