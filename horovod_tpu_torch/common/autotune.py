"""Autotuning: Bayesian optimization of runtime knobs, the port of
``horovod_tpu/common/autotune.py``.

Horovod's ParameterManager tunes the fusion threshold (and toggles) of a
running job by maximizing a bytes-per-second score with a Gaussian-
process surrogate and an expected-improvement acquisition, logging each
sample to a CSV file. The port keeps the JAX package's search as it is:
the same eleven axes (threshold, hierarchical, overlap, compression,
route, accumulation, remat, ZeRO stage and the MoE, pipeline and
sequence wires), the same candidate grids, the one-shot pruning of the
accumulation axis by the ``hvd_tpu_step_phase_seconds`` evidence, the
same CSV columns and rows and the same ``hvd_tpu_autotune_*`` metric
families. The search scores expected improvement with the port's C++
GP core (``native/gp_core.cc``, the JAX package's, copied); numpy
(:func:`numpy_ei`) computes the same quantities under
``HVD_TPU_DISABLE_NATIVE=1`` or when the C++ Cholesky fails.

Who drives it: :class:`~..optim.AutotunedStepper` (a training loop's
step times; at n > 1 rank 0 decides and every rank adopts the point at
the same call), and the eager engine's grouped allreduce in a world of
one process. A moved threshold reaches the bucket plans through
``Context.fusion_threshold()`` and the stepper's ``build``.
"""

from __future__ import annotations

import logging
import math
import threading
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np

from . import metrics as metrics_lib

logger = logging.getLogger("horovod_tpu_torch")

# Telemetry (docs/metrics.md): the live autotune point + per-config
# sample counts, on the same scrape as the step/collective metrics —
# "why did this round get faster" is answerable only when the tuner's
# decisions are recorded next to the throughput they produced.
_M_THRESHOLD = metrics_lib.gauge(
    "hvd_tpu_autotune_threshold_bytes",
    "current fusion threshold the autotuner is running")
_M_HIER = metrics_lib.gauge(
    "hvd_tpu_autotune_hierarchical", "current hierarchical toggle (0/1)")
_M_OVERLAP = metrics_lib.gauge(
    "hvd_tpu_autotune_overlap", "current overlap toggle (0/1)")
_M_COMP_IDX = metrics_lib.gauge(
    "hvd_tpu_autotune_compression_index",
    "index of the current compression candidate "
    "(see compression_candidates order; 0 = none)")
_M_ROUTE_IDX = metrics_lib.gauge(
    "hvd_tpu_autotune_route_index",
    "index of the current routing/reduction-mode candidate "
    "(see route_candidates order; 0 = flat)")
_M_ACCUM = metrics_lib.gauge(
    "hvd_tpu_autotune_accum_steps",
    "current gradient-accumulation microbatch count candidate")
_M_REMAT_IDX = metrics_lib.gauge(
    "hvd_tpu_autotune_remat_index",
    "index of the current remat-policy candidate "
    "(see remat_candidates order; 0 = none)")
_M_SHARD = metrics_lib.gauge(
    "hvd_tpu_autotune_shard_update",
    "current ZeRO-stage candidate (0 = replicated, 1 = sharded "
    "optimizer state, 2 = + sharded gradients, 3 = + sharded "
    "parameters — docs/zero.md)")
_M_MOE_WIRE_IDX = metrics_lib.gauge(
    "hvd_tpu_autotune_moe_wire_index",
    "current MoE dispatch-wire candidate index "
    "(see moe_wire_candidates order; 0 = none)")
_M_PP_WIRE_IDX = metrics_lib.gauge(
    "hvd_tpu_autotune_pp_wire_index",
    "current pipeline stage-boundary wire candidate index "
    "(see pp_wire_candidates order; 0 = none — docs/pipeline.md)")
_M_SEQ_WIRE_IDX = metrics_lib.gauge(
    "hvd_tpu_autotune_seq_wire_index",
    "current sequence-parallel K/V exchange wire candidate index "
    "(see seq_wire_candidates order; 0 = none — docs/sequence.md)")
_M_CONVERGED = metrics_lib.gauge(
    "hvd_tpu_autotune_converged", "1 once the GP+EI search locked in")
_M_SAMPLES = metrics_lib.counter(
    "hvd_tpu_autotune_samples_total",
    "scored samples per configuration (config = threshold|hierarchical"
    "|overlap|compression|route|accum|remat|shard|moe_wire|pp_wire"
    "|seq_wire)",
    labels=("config",))

_MB = 1024 * 1024
DEFAULT_CANDIDATES = tuple(int(x * _MB) for x in
                           (1, 2, 4, 8, 16, 32, 64, 128, 256))


class TunedPoint(NamedTuple):
    """The full tuned configuration (docs/autotune.md): the fusion
    threshold plus every joint toggle/candidate. Untuned axes sit at
    their defaults. ``AutotunedStepper`` build functions receive this
    whole point when any of the MFU dimensions (accum/remat/shard) are
    tuned."""

    threshold: int
    hierarchical: bool
    overlap: bool
    compression: str
    route: str
    accum: int        # gradient-accumulation microbatch count
    remat: str        # remat-policy name ("none"/"dots"/...)
    shard: int        # ZeRO stage (0 = replicated; 1/2/3 = docs/zero.md)
    # MoE dispatch wire format ("none"/"bf16"/"int8" — docs/moe.md);
    # defaulted so pre-existing 8-positional constructions keep working.
    moe_wire: str = "none"
    # Pipeline stage-boundary send wire ("none"/"bf16"/"int8" —
    # docs/pipeline.md); defaulted for the same compatibility reason.
    pp_wire: str = "none"
    # Sequence-parallel K/V exchange wire ("none"/"bf16"/"int8" —
    # ring hops and Ulysses head-scatter, docs/sequence.md); defaulted
    # for the same compatibility reason.
    seq_wire: str = "none"


def _phase_bound_accum_gate() -> bool:
    """Default pruning gate for the accumulation dimension: True
    ("explore accum>1") when the StepTimer phase histograms
    (``hvd_tpu_step_phase_seconds``, docs/metrics.md) show the step is
    COMM-BOUND (comm phase >= 15% of the phase-timed step) — the regime
    where amortizing the collective round over k microbatches pays — or
    when no phase evidence exists yet (memory pressure is invisible
    from here; never prune blind). A compute-dominated step gets the
    accum>1 candidates pruned: each would recompile and sample for
    nothing."""
    try:
        snap = metrics_lib.snapshot()
        samples = snap.get("hvd_tpu_step_phase_seconds", {}) \
            .get("samples", [])
        sums = {}
        for s in samples:
            v = s.get("value")
            if isinstance(v, dict) and v.get("count"):
                sums[s["labels"].get("phase", "?")] = float(v["sum"])
        total = sum(sums.values())
        if not total or "comm" not in sums:
            return True
        return sums["comm"] / total >= 0.15
    except Exception:  # noqa: BLE001 — telemetry must not break tuning
        return True


class GaussianProcess:
    """Minimal RBF-kernel GP regressor (reference gaussian_process.cc)."""

    def __init__(self, length_scale: float = 1.0, noise: float = 1e-4):
        self.length_scale = length_scale
        self.noise = noise
        self._x: Optional[np.ndarray] = None
        self._y: Optional[np.ndarray] = None
        self._k_inv: Optional[np.ndarray] = None

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d = a[:, None, :] - b[None, :, :]
        return np.exp(-0.5 * (d ** 2).sum(-1) / self.length_scale ** 2)

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        self._x = np.atleast_2d(x)
        self._y = np.asarray(y, dtype=float)
        k = self._kernel(self._x, self._x)
        k += self.noise * np.eye(len(self._x))
        self._k_inv = np.linalg.inv(k)

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        assert self._x is not None
        x = np.atleast_2d(x)
        ks = self._kernel(x, self._x)
        mu = ks @ self._k_inv @ self._y
        kss = self._kernel(x, x).diagonal()
        var = kss - (ks @ self._k_inv * ks).sum(-1)
        return mu, np.maximum(var, 1e-12)


def numpy_ei(xs: np.ndarray, ys: np.ndarray, grid: np.ndarray,
             length_scale: float = 1.0) -> np.ndarray:
    """EI of every ``grid`` point under a GP fitted on ``(xs, ys)`` —
    the numpy mirror of ``native.gp_ei_native``."""
    gp = GaussianProcess(length_scale=length_scale)
    gp.fit(xs, ys)
    mu, var = gp.predict(grid)
    return expected_improvement(mu, var, ys.max())


def expected_improvement(mu: np.ndarray, var: np.ndarray,
                         best: float, xi: float = 0.01) -> np.ndarray:
    """EI acquisition (reference bayesian_optimization.cc)."""
    from math import erf, sqrt

    sigma = np.sqrt(var)
    imp = mu - best - xi
    z = np.where(sigma > 0, imp / sigma, 0.0)
    cdf = 0.5 * (1.0 + np.vectorize(erf)(z / sqrt(2.0)))
    pdf = np.exp(-0.5 * z ** 2) / np.sqrt(2 * np.pi)
    ei = imp * cdf + sigma * pdf
    return np.where(sigma > 0, ei, 0.0)


class Autotuner:
    """Tunes the fusion threshold online from observed step throughput.

    Usage (wired into DistributedOptimizer via config.autotune, or driven
    manually)::

        tuner = Autotuner(candidates_bytes=...)
        while training:
            t0 = time.perf_counter()
            step()
            tuner.record(bytes_reduced, time.perf_counter() - t0)
            if tuner.ready():
                new_threshold = tuner.suggest()

    Scoring = bytes/sec, matching the reference (parameter_manager.h:42).
    """

    def __init__(self,
                 candidates_bytes: Sequence[int] = DEFAULT_CANDIDATES,
                 warmup_samples: int = 3,
                 steps_per_sample: int = 10,
                 log_file: Optional[str] = None,
                 tune_hierarchical: bool = False,
                 tune_overlap: bool = False,
                 tune_compression: bool = False,
                 compression_candidates: Sequence[str] = (
                     "none", "bf16", "int8_ef"),
                 tune_route: bool = False,
                 route_candidates: Sequence[str] = (
                     "flat", "staged", "staged_int8", "adasum"),
                 tune_accum: bool = False,
                 accum_candidates: Sequence[int] = (1, 2, 4, 8),
                 tune_remat: bool = False,
                 remat_candidates: Sequence[str] = (
                     "none", "dots", "full"),
                 tune_shard: bool = False,
                 shard_candidates: Sequence[int] = (0, 1, 2, 3),
                 tune_moe_wire: bool = False,
                 moe_wire_candidates: Sequence[str] = (
                     "none", "bf16", "int8"),
                 tune_pp_wire: bool = False,
                 pp_wire_candidates: Sequence[str] = (
                     "none", "bf16", "int8"),
                 tune_seq_wire: bool = False,
                 seq_wire_candidates: Sequence[str] = (
                     "none", "bf16", "int8"),
                 accum_gate: Optional[Callable[[], bool]] = None):
        self.candidates = list(candidates_bytes)
        self.warmup = warmup_samples
        self.steps_per_sample = steps_per_sample
        self.log_file = log_file
        # Joint (threshold, hierarchical, overlap, compression) space
        # when asked — the reference's ParameterManager tunes the
        # hierarchical toggle alongside the fusion threshold
        # (parameter_manager.cc); the overlap toggle (readiness-ordered
        # buckets + issue chaining, common/overlap.py) and the
        # compression axis (reduction wire format: none / bf16 cast /
        # int8_ef quantized allreduce — whether 4x fewer wire bytes beat
        # the quantize/dequant overhead is topology- and model-
        # dependent, so measured, not guessed) are this rebuild's
        # additions. Points are always internal 4-tuples (threshold,
        # hierarchical, overlap, compression_index); untuned axes stay
        # pinned at 0.
        self.tune_hierarchical = tune_hierarchical
        self.tune_overlap = tune_overlap
        self.tune_compression = tune_compression
        # Routing/reduction-mode axis (docs/topology.md): which WirePlan
        # (and whether Adasum replaces SUM on the slow axis) the step
        # builds with — "flat" | "staged" | "staged_int8" | "adasum".
        # Whether staging (and per-axis int8) beats the flat ring is a
        # topology-and-model question, so it is measured, not
        # hand-picked, exactly like the compression axis.
        self.tune_route = tune_route
        self.route_candidates = (tuple(route_candidates)
                                 if tune_route else ("flat",))
        self.compression_candidates = (tuple(compression_candidates)
                                       if tune_compression else ("none",))
        # The MFU dimensions (ROADMAP item 2, docs/performance.md):
        # gradient-accumulation microbatch count, remat policy (the two
        # tune JOINTLY — remat frees the memory accumulation needs),
        # and the weight-update-sharding toggle (ZeRO-1 as a measured
        # candidate, arXiv:1909.09756). Accumulation candidates are
        # PRUNED at the first sample boundary unless the step shows
        # comm- or memory-bound evidence (accum_gate; default reads the
        # StepTimer phase histograms) — a compute-bound step would pay
        # the full recompile-and-sample cost of every accum point for
        # no reachable win.
        self.tune_accum = tune_accum
        self.accum_candidates = (tuple(int(a) for a in accum_candidates)
                                 if tune_accum else (1,))
        self.tune_remat = tune_remat
        self.remat_candidates = (tuple(remat_candidates)
                                 if tune_remat else ("none",))
        self.tune_shard = tune_shard
        # The shard axis is the ZeRO STAGE (docs/zero.md), widened from
        # the historical on/off toggle: 0 = replicated update, 1 =
        # sharded optimizer state, 2 = + sharded gradient accumulation,
        # 3 = + sharded parameters with gather-on-demand. Candidates
        # are stage numbers, pruned by the caller (e.g. bench passes
        # (0, 1) when the model cannot run the stage-3 step shape).
        self.shard_candidates = (tuple(int(x) for x in shard_candidates)
                                 if tune_shard else (0,))
        # The MoE dispatch-wire axis (docs/moe.md): which payload
        # format the expert-parallel alltoall carries — none / bf16 /
        # int8. Same trade as the reduction-compression axis (wire
        # bytes vs quantize overhead, plus an accuracy term the loss
        # already prices), on the PERMUTE family.
        self.tune_moe_wire = tune_moe_wire
        self.moe_wire_candidates = (tuple(moe_wire_candidates)
                                    if tune_moe_wire else ("none",))
        # The pipeline stage-boundary wire axis (docs/pipeline.md):
        # which payload format the 1F1B activation/cotangent ppermutes
        # carry. Same wire-bytes-vs-quantize-overhead trade as the MoE
        # dispatch axis, on the pipeline's send family.
        self.tune_pp_wire = tune_pp_wire
        self.pp_wire_candidates = (tuple(pp_wire_candidates)
                                   if tune_pp_wire else ("none",))
        # The sequence-parallel exchange-wire axis (docs/sequence.md):
        # which payload format the ring K/V hops / Ulysses head-scatter
        # alltoalls carry. Same wire-bytes-vs-quantize-overhead trade
        # again, on the sp axis (hvd_tpu_seq_kv_bytes_total).
        self.tune_seq_wire = tune_seq_wire
        self.seq_wire_candidates = (tuple(seq_wire_candidates)
                                    if tune_seq_wire else ("none",))
        self.accum_gate = accum_gate
        self._accum_pruned = False
        hs = (0, 1) if tune_hierarchical else (0,)
        ovs = (0, 1) if tune_overlap else (0,)
        cs = tuple(range(len(self.compression_candidates)))
        rs = tuple(range(len(self.route_candidates)))
        accs = tuple(range(len(self.accum_candidates)))
        rms = tuple(range(len(self.remat_candidates)))
        shs = tuple(range(len(self.shard_candidates)))
        mws = tuple(range(len(self.moe_wire_candidates)))
        pws = tuple(range(len(self.pp_wire_candidates)))
        sws = tuple(range(len(self.seq_wire_candidates)))
        self._space: List[Tuple[int, ...]] = [
            (t, h, o, c, rt, a, m, s, mw, pw, sw)
            for t in self.candidates
            for h in hs for o in ovs for c in cs for rt in rs
            for a in accs for m in rms for s in shs for mw in mws
            for pw in pws for sw in sws]
        self._steps = 0
        self._warmed = 0
        self._bytes = 0.0
        self._secs = 0.0
        self._samples: Dict[Tuple[int, ...], List[float]] = {}
        self.last_search = None
        self._cur = self._space[len(self._space) // 2]
        self._done = False
        # Samples arrive from finalizer-pool threads (eager engine) and
        # the training loop (AutotunedStepper) concurrently; all state
        # transitions are serialized here.
        self._tlock = threading.RLock()
        # Single source for the CSV schema: row values come from the
        # same column list as the header (see _row).
        cols = ["threshold_bytes"]
        if tune_hierarchical:
            cols.append("hierarchical")
        if tune_overlap:
            cols.append("overlap")
        if tune_compression:
            cols.append("compression")
        if tune_route:
            cols.append("route")
        if tune_accum:
            cols.append("accum")
        if tune_remat:
            cols.append("remat")
        if tune_shard:
            cols.append("shard")
        if tune_moe_wire:
            cols.append("moe_wire")
        if tune_pp_wire:
            cols.append("pp_wire")
        if tune_seq_wire:
            cols.append("seq_wire")
        self._columns = tuple(cols)
        self._publish_metrics()
        if log_file:
            # Decision trace (reference HOROVOD_AUTOTUNE_LOG,
            # parameter_manager.cc LogParameters): when + what was
            # tried + how it scored + on how many step samples.
            with open(log_file, "w") as f:
                f.write("unix_time," + ",".join(self._columns)
                        + ",score_bytes_per_sec,steps\n")

    @property
    def current(self) -> int:
        with self._tlock:
            return self._cur[0]

    @property
    def current_hierarchical(self) -> bool:
        with self._tlock:
            return bool(self._cur[1])

    @property
    def current_overlap(self) -> bool:
        with self._tlock:
            return bool(self._cur[2])

    @property
    def current_point(self) -> Tuple[int, bool]:
        """Atomic (threshold, hierarchical) snapshot — readers that need
        both must not take them in two lock acquisitions (a concurrent
        suggest() in between would yield a pair the tuner never
        proposed)."""
        with self._tlock:
            return self._cur[0], bool(self._cur[1])

    @property
    def current_triple(self) -> Tuple[int, bool, bool]:
        """Atomic (threshold, hierarchical, overlap) snapshot."""
        with self._tlock:
            return self._cur[0], bool(self._cur[1]), bool(self._cur[2])

    @property
    def current_compression(self) -> str:
        with self._tlock:
            return self.compression_candidates[self._cur[3]]

    @property
    def current_route(self) -> str:
        with self._tlock:
            return self.route_candidates[self._cur[4]]

    @property
    def current_quad(self) -> Tuple[int, bool, bool, str]:
        """Atomic (threshold, hierarchical, overlap, compression)
        snapshot."""
        return self.current_quint[:4]

    @property
    def current_quint(self) -> Tuple[int, bool, bool, str, str]:
        """Atomic (threshold, hierarchical, overlap, compression,
        route) snapshot — the historical 5-axis point (the MFU axes
        are on :attr:`current_full`)."""
        with self._tlock:
            return (self._cur[0], bool(self._cur[1]), bool(self._cur[2]),
                    self.compression_candidates[self._cur[3]],
                    self.route_candidates[self._cur[4]])

    @property
    def current_accum(self) -> int:
        with self._tlock:
            return self.accum_candidates[self._cur[5]]

    @property
    def current_remat(self) -> str:
        with self._tlock:
            return self.remat_candidates[self._cur[6]]

    @property
    def current_shard(self) -> int:
        with self._tlock:
            return self.shard_candidates[self._cur[7]]

    @property
    def current_moe_wire(self) -> str:
        with self._tlock:
            return self.moe_wire_candidates[self._cur[8]]

    @property
    def current_pp_wire(self) -> str:
        with self._tlock:
            return self.pp_wire_candidates[self._cur[9]]

    @property
    def current_seq_wire(self) -> str:
        with self._tlock:
            return self.seq_wire_candidates[self._cur[10]]

    @property
    def current_full(self) -> TunedPoint:
        """Atomic snapshot of the FULL tuned point (all 11 axes)."""
        with self._tlock:
            return self._point_of(self._cur)

    def _point_of(self, cur: Tuple[int, ...]) -> TunedPoint:
        return TunedPoint(
            threshold=cur[0], hierarchical=bool(cur[1]),
            overlap=bool(cur[2]),
            compression=self.compression_candidates[cur[3]],
            route=self.route_candidates[cur[4]],
            accum=self.accum_candidates[cur[5]],
            remat=self.remat_candidates[cur[6]],
            shard=self.shard_candidates[cur[7]],
            moe_wire=self.moe_wire_candidates[cur[8]],
            pp_wire=self.pp_wire_candidates[cur[9]],
            seq_wire=self.seq_wire_candidates[cur[10]])

    @property
    def done(self) -> bool:
        with self._tlock:
            return self._done

    def record(self, nbytes: float, seconds: float) -> None:
        with self._tlock:
            if self._done:
                return
            if self._warmed < self.warmup:
                self._warmed += 1      # discard warmup (compile) samples
                return
            self._bytes += nbytes
            self._secs += seconds
            self._steps += 1

    def ready(self) -> bool:
        with self._tlock:
            return not self._done and self._steps >= self.steps_per_sample

    def feed(self, nbytes: float, seconds: float) -> int:
        """Atomic record + (if a sample completed) suggest — the one call
        sites should use when multiple threads feed the tuner. Returns the
        (possibly updated) current threshold."""
        return self.feed_point(nbytes, seconds)[0]

    def feed_point(self, nbytes: float,
                   seconds: float) -> Tuple[int, bool]:
        """Like feed() but returns the full (threshold, hierarchical)
        point under ONE lock acquisition."""
        return self.feed_triple(nbytes, seconds)[:2]

    def feed_triple(self, nbytes: float,
                    seconds: float) -> Tuple[int, bool, bool]:
        """Like feed() but returns the full (threshold, hierarchical,
        overlap) point under ONE lock acquisition."""
        return self.feed_quad(nbytes, seconds)[:3]

    def feed_quad(self, nbytes: float,
                  seconds: float) -> Tuple[int, bool, bool, str]:
        """Like feed() but returns the full (threshold, hierarchical,
        overlap, compression) point under ONE lock acquisition."""
        return self.feed_quint(nbytes, seconds)[:4]

    def feed_quint(self, nbytes: float,
                   seconds: float) -> Tuple[int, bool, bool, str, str]:
        """Like feed() but returns the historical 5-axis (threshold,
        hierarchical, overlap, compression, route) point under ONE
        lock acquisition."""
        return tuple(self.feed_full(nbytes, seconds)[:5])

    def feed_full(self, nbytes: float, seconds: float) -> TunedPoint:
        """Atomic record + (if a sample completed) suggest, returning
        the FULL 8-axis :class:`TunedPoint` under one lock acquisition
        — the call AutotunedStepper uses."""
        with self._tlock:
            self.record(nbytes, seconds)
            if self.ready():
                self._suggest_locked()
            return self._point_of(self._cur)

    def adopt(self, point: TunedPoint, done: bool = False) -> None:
        """Make ``point`` (another rank's decision) this tuner's current
        one, and converged with ``done``: a rank that does not decide
        (``AutotunedStepper`` at n > 1) then publishes the point its
        world runs at. An axis this tuner does not tune keeps its
        value."""
        with self._tlock:
            def index(candidates, value, axis):
                return candidates.index(value) if value in candidates \
                    else self._cur[axis]

            self._cur = (
                int(point.threshold), int(point.hierarchical),
                int(point.overlap),
                index(self.compression_candidates, point.compression, 3),
                index(self.route_candidates, point.route, 4),
                index(self.accum_candidates, point.accum, 5),
                index(self.remat_candidates, point.remat, 6),
                index(self.shard_candidates, point.shard, 7),
                index(self.moe_wire_candidates, point.moe_wire, 8),
                index(self.pp_wire_candidates, point.pp_wire, 9),
                self._cur[10])
            self._done = self._done or done
            self._publish_metrics()

    def _config_label(self, point: Tuple[int, ...]) -> str:
        return (f"{point[0]}|{int(point[1])}|{int(point[2])}"
                f"|{self.compression_candidates[point[3]]}"
                f"|{self.route_candidates[point[4]]}"
                f"|{self.accum_candidates[point[5]]}"
                f"|{self.remat_candidates[point[6]]}|{int(point[7])}"
                f"|{self.moe_wire_candidates[point[8]]}"
                f"|{self.pp_wire_candidates[point[9]]}"
                f"|{self.seq_wire_candidates[point[10]]}")

    def _publish_metrics(self) -> None:
        """Mirror the live point into the metrics registry (called with
        the tuner lock held or from __init__ before threads exist)."""
        _M_THRESHOLD.set(self._cur[0])
        _M_HIER.set(self._cur[1])
        _M_OVERLAP.set(self._cur[2])
        _M_COMP_IDX.set(self._cur[3])
        _M_ROUTE_IDX.set(self._cur[4])
        _M_ACCUM.set(self.accum_candidates[self._cur[5]])
        _M_REMAT_IDX.set(self._cur[6])
        _M_SHARD.set(self.shard_candidates[self._cur[7]])
        _M_MOE_WIRE_IDX.set(self._cur[8])
        _M_PP_WIRE_IDX.set(self._cur[9])
        _M_SEQ_WIRE_IDX.set(self._cur[10])
        _M_CONVERGED.set(1.0 if self._done else 0.0)

    def _row(self, point: Tuple[int, ...]) -> List:
        """CSV row values matching _columns: the threshold always, each
        toggle only when tuned (an untuned axis would log a constant 0
        column that the header doesn't declare)."""
        row: List = [point[0]]
        if self.tune_hierarchical:
            row.append(point[1])
        if self.tune_overlap:
            row.append(point[2])
        if self.tune_compression:
            row.append(self.compression_candidates[point[3]])
        if self.tune_route:
            row.append(self.route_candidates[point[4]])
        if self.tune_accum:
            row.append(self.accum_candidates[point[5]])
        if self.tune_remat:
            row.append(self.remat_candidates[point[6]])
        if self.tune_shard:
            row.append(self.shard_candidates[point[7]])
        if self.tune_moe_wire:
            row.append(self.moe_wire_candidates[point[8]])
        if self.tune_pp_wire:
            row.append(self.pp_wire_candidates[point[9]])
        if self.tune_seq_wire:
            row.append(self.seq_wire_candidates[point[10]])
        return row

    def _log(self, point: Tuple[int, ...], score: float) -> None:
        if self.log_file:
            import time as _time

            with open(self.log_file, "a") as f:
                f.write(f"{_time.time():.3f},"
                        + ",".join(str(v) for v in self._row(point))
                        + f",{score:.1f},{self._steps}\n")

    def suggest(self) -> int:
        """Finalize the current sample and pick the next threshold via
        GP+EI; converges when EI is negligible everywhere."""
        with self._tlock:
            return self._suggest_locked()

    def _features(self, point: Tuple[int, ...]) -> List[float]:
        # log2(threshold) spans ~20-28; scale the binary toggles (and the
        # categorical compression/route/remat indices) so the RBF kernel
        # treats "other branch" as a real distance. Accumulation enters
        # as log2(k) — neighboring microbatch counts genuinely are
        # neighboring configurations.
        return [math.log2(point[0]), 2.0 * point[1], 2.0 * point[2],
                2.0 * point[3], 2.0 * point[4],
                math.log2(max(self.accum_candidates[point[5]], 1)),
                2.0 * point[6], 2.0 * point[7], 2.0 * point[8],
                2.0 * point[9], 2.0 * point[10]]

    def _maybe_prune_accum(self) -> None:
        """One-shot accumulation-space pruning, decided at the FIRST
        sample boundary (by then the StepTimer phase histograms have
        real step evidence): when the gate says the step is
        compute-bound, accum>1 candidates are dropped — already-sampled
        points stay (their scores are evidence, and re-adding them to
        the GP costs nothing)."""
        if self._accum_pruned or not self.tune_accum:
            return
        self._accum_pruned = True
        gate = self.accum_gate if self.accum_gate is not None \
            else _phase_bound_accum_gate
        try:
            allowed = bool(gate())
        except Exception:  # noqa: BLE001 — a broken gate must not
            allowed = True  # wedge tuning; explore instead
        if allowed:
            return
        before = len(self._space)
        self._space = [p for p in self._space
                       if p[5] == 0 or p in self._samples]
        logger.info(
            "autotune: step is compute-bound (StepTimer phases) — "
            "pruned %d accumulation candidates from the search space",
            before - len(self._space))

    def _suggest_locked(self) -> int:
        self._maybe_prune_accum()
        score = self._bytes / max(self._secs, 1e-9)
        self._samples.setdefault(self._cur, []).append(score)
        _M_SAMPLES.labels(config=self._config_label(self._cur)).inc()
        self._log(self._cur, score)
        self._bytes = self._secs = 0.0
        self._steps = 0
        self._warmed = 0  # re-warm after a move (the re-plan's first steps)

        xs = np.array([self._features(p) for p in self._samples])
        ys = np.array([float(np.mean(v)) for v in self._samples.values()])
        y_mean, y_std = ys.mean(), max(ys.std(), 1e-9)
        ys_n = (ys - y_mean) / y_std
        grid = np.array([self._features(p) for p in self._space])

        # The C++ GP+EI core (native/gp_core.cc); numpy computes the same
        # quantities when the library is disabled or its Cholesky failed.
        from .. import native

        native_out = native.gp_ei_native(xs, ys_n, grid, length_scale=1.0)
        if native_out is not None:
            ei = np.asarray(native_out[1])
        else:
            ei = numpy_ei(xs, ys_n, grid)
        #: The last search's inputs and EI, and whether the C++ core made
        #: it (the smoke holds it against :func:`numpy_ei`).
        self.last_search = (xs, ys_n, grid, ei, native_out is not None)

        untried = [i for i, p in enumerate(self._space)
                   if p not in self._samples]
        if untried:
            # Explore the untried candidate with max EI first.
            i = max(untried, key=lambda j: ei[j])
        else:
            i = int(np.argmax(ei))
            if ei[i] < 1e-3:
                # Converged: lock in the empirically best point.
                best = max(self._samples,
                           key=lambda p: float(np.mean(self._samples[p])))
                self._cur = best
                self._done = True
                self._publish_metrics()
                logger.info(
                    "autotune converged: fusion threshold %d MiB"
                    + (", hierarchical=%s" % bool(best[1])
                       if self.tune_hierarchical else "")
                    + (", overlap=%s" % bool(best[2])
                       if self.tune_overlap else "")
                    + (", compression=%s"
                       % self.compression_candidates[best[3]]
                       if self.tune_compression else "")
                    + (", route=%s" % self.route_candidates[best[4]]
                       if self.tune_route else "")
                    + (", accum=%d" % self.accum_candidates[best[5]]
                       if self.tune_accum else "")
                    + (", remat=%s" % self.remat_candidates[best[6]]
                       if self.tune_remat else "")
                    + (", zero_stage=%s" % self.shard_candidates[best[7]]
                       if self.tune_shard else "")
                    + (", moe_wire=%s" % self.moe_wire_candidates[best[8]]
                       if self.tune_moe_wire else "")
                    + (", pp_wire=%s" % self.pp_wire_candidates[best[9]]
                       if self.tune_pp_wire else "")
                    + (", seq_wire=%s"
                       % self.seq_wire_candidates[best[10]]
                       if self.tune_seq_wire else ""),
                    best[0] // _MB)
                return best[0]
        self._cur = self._space[i]
        self._publish_metrics()
        return self._cur[0]
