"""Training-integrity guard of the port — its copy of
``horovod_tpu/common/integrity.py`` for eager PyTorch.

* **Non-finite gradient guard.** ``DistributedOptimizer(nonfinite_policy=)``
  (``optim.py``) takes an all-finite flag over each rank's LOCAL fused
  buckets before any reduction, agrees it across ranks with one MIN
  all-reduce of one int32 at ``synchronize()``, and reacts by policy
  (``HVD_TPU_NONFINITE_POLICY``):

  =================  ======================================================
  policy             reaction to a globally agreed non-finite gradient
  =================  ======================================================
  ``warn``           apply the update anyway; count the step
  ``skip_step``      no update: weights, optimizer state and the int8_ef
                     residual and step stay as they were
  ``zero``           replace non-finite gradient entries with 0, proceed
  ``scale_backoff``  dynamic loss scaling: the gradients are unscaled by
                     the carried ``loss_scale``; a bad step skips and backs
                     the scale off; ``growth_steps`` good steps in a row
                     grow it back
  ``abort``          skip (state protected), then :func:`check_abort` /
                     ``observe_guard`` raises :class:`NonFiniteError`
  =================  ======================================================

  The JAX package branches inside the traced step with ``lax.cond`` and
  never leaves the device. Eager PyTorch must know before
  ``optimizer.step()`` whether to call the base optimizer, so
  ``skip_step``, ``scale_backoff`` and ``abort`` read the agreed flag on
  the host once a step (as ``torch.amp.GradScaler`` does); ``warn`` and
  ``zero`` never branch, and their counters stay on the device until
  :func:`observe_guard` reads them.

* **Divergence detection.** A fingerprint of the parameters (chunk L2
  norms and a fixed strided sample) compared across ranks:
  :func:`check_divergence` by a MAX − MIN all-reduce, or
  :class:`DivergenceDetector` by exchanging its crc32 digest through the
  controller and naming the minority. Policies ``warn`` | ``abort`` |
  ``resync`` (a broadcast of the parameters from rank 0, counted in
  ``RecoveryStats``). The JAX package's in-trace ``divergence_guard`` is
  a host call here with the same contract, made at the top of a step.
  :func:`sharded_fingerprint` is the digest of a sharded (ZeRO) state,
  summed over the ranks instead of compared.

The chaos hooks :func:`chaos_poison` (the ``nonfinite`` site, wired into
the eager allreduce's input) and :func:`chaos_perturb` (the ``diverge``
site) consume the fault plan of ``common/faults.py``.

Metrics: ``hvd_tpu_nonfinite_steps_total{policy=}`` (published by
``observe_guard``), ``hvd_tpu_divergence_checks_total{result=}``.
"""

from __future__ import annotations

import dataclasses
import logging
import zlib
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from . import faults as faults_lib
from . import metrics as metrics_lib
from . import tree as tree_lib
from .config import env_float, env_int, runtime_env
from .exceptions import DivergenceError, NonFiniteError

logger = logging.getLogger("horovod_tpu_torch")

NONFINITE_POLICIES = ("warn", "skip_step", "zero", "scale_backoff",
                      "abort")
DIVERGE_POLICIES = ("warn", "abort", "resync")
#: The policies that read the agreed flag on the host and skip a bad step.
SKIPPING_POLICIES = ("skip_step", "scale_backoff", "abort")

_M_NONFINITE = metrics_lib.counter(
    "hvd_tpu_nonfinite_steps_total",
    "training steps whose global all-finite gradient flag was false, "
    "by non-finite policy (published by hvd.observe_guard)",
    labels=("policy",))
_M_DIVERGE = metrics_lib.counter(
    "hvd_tpu_divergence_checks_total",
    "cross-rank parameter-fingerprint divergence checks by result "
    "(ok / diverged / resync)",
    labels=("result",))
for _p in NONFINITE_POLICIES:
    _M_NONFINITE.labels(policy=_p)
for _r in ("ok", "diverged", "resync"):
    _M_DIVERGE.labels(result=_r)
del _p, _r


def _config():
    from . import basics

    return basics.context().config if basics.is_initialized() else None


def resolve_nonfinite_policy(policy: Optional[str] = None) -> Optional[str]:
    """None -> the configured default (``init(nonfinite_policy=)`` /
    ``HVD_TPU_NONFINITE_POLICY``); ""/"off" -> disabled (None). An
    unknown policy raises: a typo must not silently disable the guard."""
    if policy is None:
        cfg = _config()
        policy = cfg.nonfinite_policy if cfg is not None \
            else runtime_env("NONFINITE_POLICY")
    if not policy or policy == "off":
        return None
    if policy not in NONFINITE_POLICIES:
        raise ValueError(
            f"unknown non-finite policy {policy!r}; known: "
            f"{('off',) + NONFINITE_POLICIES}")
    return policy


def resolve_diverge_policy(policy: Optional[str] = None) -> str:
    if policy is None:
        cfg = _config()
        policy = cfg.diverge_policy if cfg is not None \
            else runtime_env("DIVERGE_POLICY", "warn")
    policy = policy or "warn"
    if policy not in DIVERGE_POLICIES:
        raise ValueError(f"unknown divergence policy {policy!r}; known: "
                         f"{DIVERGE_POLICIES}")
    return policy


@dataclasses.dataclass(frozen=True)
class ScaleConfig:
    """Dynamic loss-scaling schedule of ``scale_backoff``: back off
    multiplicatively on a bad step, grow back after a streak of good
    ones."""

    init: float = 2.0 ** 15
    backoff: float = 0.5
    growth: float = 2.0
    growth_steps: int = 200
    min: float = 1.0
    max: float = 2.0 ** 24

    @classmethod
    def from_env(cls) -> "ScaleConfig":
        return cls(
            init=env_float("SCALE_INIT", cls.init),
            backoff=env_float("SCALE_BACKOFF_FACTOR", cls.backoff),
            growth=env_float("SCALE_GROWTH_FACTOR", cls.growth),
            growth_steps=env_int("SCALE_GROWTH_STEPS", cls.growth_steps),
            min=env_float("SCALE_MIN", cls.min),
            max=env_float("SCALE_MAX", cls.max))


Count = Union[int, torch.Tensor]


@dataclasses.dataclass
class GuardState:
    """The guard's carried state: the policy, the count of globally
    non-finite steps, the current good-step streak, the dynamic loss
    scale (an fp32 value; 1.0 unless ``scale_backoff``) and whether the
    LAST step was finite. Under the skipping policies the counts are
    Python numbers (the flag is read on the host anyway); under ``warn``
    and ``zero`` they are 0-d int32 tensors on the device, so that no
    step waits on the card for them."""

    policy: str
    nonfinite_steps: Count = 0
    good_steps: Count = 0
    loss_scale: float = 1.0
    last_ok: Union[bool, torch.Tensor] = True

    def snapshot(self) -> dict:
        """The state as host numbers (reads device counters)."""
        return {"policy": self.policy,
                "nonfinite_steps": int(self.nonfinite_steps),
                "good_steps": int(self.good_steps),
                "loss_scale": float(self.loss_scale),
                "last_ok": bool(self.last_ok)}

    def load(self, snap: dict) -> None:
        """Restore the counters of :meth:`snapshot` (the policy stays)."""
        if self.policy in SKIPPING_POLICIES:
            self.nonfinite_steps = int(snap["nonfinite_steps"])
            self.good_steps = int(snap["good_steps"])
            self.last_ok = bool(snap["last_ok"])
        else:
            dev = self.nonfinite_steps.device
            self.nonfinite_steps = torch.tensor(
                int(snap["nonfinite_steps"]), dtype=torch.int32, device=dev)
            self.good_steps = torch.tensor(int(snap["good_steps"]),
                                           dtype=torch.int32, device=dev)
            self.last_ok = torch.tensor(int(bool(snap["last_ok"])),
                                        dtype=torch.int32, device=dev)
        self.loss_scale = float(np.float32(snap["loss_scale"]))


def init_guard_state(policy: str, scale: Optional[ScaleConfig] = None,
                     device=None) -> GuardState:
    """A fresh guard for ``policy``; ``device`` holds the counters of
    ``warn``/``zero``."""
    if policy not in NONFINITE_POLICIES:
        raise ValueError(f"unknown non-finite policy {policy!r}")
    scale = scale if scale is not None else ScaleConfig.from_env()
    init_scale = scale.init if policy == "scale_backoff" else 1.0
    g = GuardState(policy, loss_scale=float(np.float32(init_scale)))
    if policy not in SKIPPING_POLICIES:
        zero = torch.zeros((), dtype=torch.int32, device=device)
        g.nonfinite_steps, g.good_steps = zero, zero.clone()
        g.last_ok = torch.ones((), dtype=torch.int32, device=device)
    return g


def inverse_scale(guard: GuardState) -> np.float32:
    """``1 / loss_scale`` in fp32, the factor ``scale_backoff`` unscales
    the gradients by (rounded again to each gradient's dtype)."""
    return np.float32(1.0) / np.float32(guard.loss_scale)


def advance(guard: GuardState, ok, scale: ScaleConfig) -> None:
    """One agreed step's update of ``guard`` (``integrity.py``'s
    ``guarded_apply`` tail): ``ok`` is a bool under the skipping policies
    and a device bool tensor under ``warn``/``zero``."""
    if isinstance(ok, torch.Tensor):
        okd = ok.to(device=guard.good_steps.device)
        guard.good_steps = torch.where(okd, guard.good_steps + 1,
                                       torch.zeros_like(guard.good_steps))
        guard.nonfinite_steps = guard.nonfinite_steps + (~okd).to(
            torch.int32)
        guard.last_ok = okd.to(torch.int32)
        return
    good = guard.good_steps + 1 if ok else 0
    if guard.policy == "scale_backoff":
        ls = np.float32(guard.loss_scale)
        grown = np.minimum(ls * np.float32(scale.growth),
                           np.float32(scale.max))
        backed = np.maximum(ls * np.float32(scale.backoff),
                            np.float32(scale.min))
        grow_now = good >= scale.growth_steps
        ls = backed if not ok else (grown if grow_now else ls)
        guard.loss_scale = float(ls)
        if grow_now:
            good = 0
    guard.good_steps = good
    guard.nonfinite_steps = guard.nonfinite_steps + (0 if ok else 1)
    guard.last_ok = bool(ok)


def all_finite(tree) -> torch.Tensor:
    """0-d bool tensor: every float leaf of ``tree`` is finite (one AND
    over the leaves; integer leaves are finite by construction)."""
    ok = None
    for leaf in tree_lib.tensors(tree):
        if leaf.is_floating_point():
            f = torch.isfinite(leaf).all()
            ok = f if ok is None else torch.logical_and(ok, f)
    return torch.ones((), dtype=torch.bool) if ok is None else ok


def sanitize(tree):
    """The ``zero`` policy's transform: non-finite entries of float leaves
    become 0 (not ``nan_to_num``, which maps ±Inf to ±max)."""
    def one(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            return torch.where(torch.isfinite(leaf), leaf,
                               torch.zeros_like(leaf))
        return leaf

    return tree_lib.map_tree(one, tree)


def find_guard(state) -> Optional[GuardState]:
    """The :class:`GuardState` of a guarded ``DistributedOptimizer`` (or
    a GuardState, or anything with a ``.guard``; walks ``.inner``)."""
    seen = 0
    while state is not None and seen < 8:
        if isinstance(state, GuardState):
            return state
        for attr in ("_guard", "guard"):
            g = getattr(state, attr, None)
            if isinstance(g, GuardState):
                return g
        state = getattr(state, "inner", None)
        seen += 1
    return None


def current_loss_scale(optimizer) -> float:
    """The live dynamic loss scale of a guarded optimizer (1.0 unless the
    ``scale_backoff`` policy is active). Multiply the loss by it before
    ``backward()``::

        (loss * hvd.current_loss_scale(opt)).backward()
    """
    g = find_guard(optimizer)
    return 1.0 if g is None else float(g.loss_scale)


# Per-(policy, name) high-water marks for delta publishing: processes
# observing SEVERAL guarded optimizers under one policy pass distinct
# ``name=``s.
_published_nonfinite = {}


def observe_guard(optimizer, raise_on_abort: bool = True,
                  name: str = "default") -> Optional[dict]:
    """Host-side guard observation: reads the counters, publishes the
    delta into ``hvd_tpu_nonfinite_steps_total{policy=}`` and, under
    ``abort`` with non-finite steps on record, raises
    :class:`NonFiniteError` (those steps were skipped, so the state is
    intact). Returns the snapshot dict, or None without a guard."""
    g = find_guard(optimizer)
    if g is None:
        return None
    snap = g.snapshot()
    policy = snap["policy"]
    stream = (policy, name)
    prev = _published_nonfinite.get(stream, 0)
    if snap["nonfinite_steps"] < prev:
        # The counter rewound (a restore, a fresh optimizer under the
        # same stream): re-anchor the high-water mark.
        _published_nonfinite[stream] = prev = snap["nonfinite_steps"]
    if snap["nonfinite_steps"] > prev:
        _M_NONFINITE.labels(policy=policy).inc(
            snap["nonfinite_steps"] - prev)
        _published_nonfinite[stream] = snap["nonfinite_steps"]
    if raise_on_abort:
        check_abort(snap)
    return snap


def check_abort(snapshot: dict) -> None:
    """Raise NonFiniteError for an ``abort``-policy guard that has seen
    non-finite steps (takes an :func:`observe_guard` snapshot)."""
    if snapshot.get("policy") == "abort" and \
            snapshot.get("nonfinite_steps", 0) > 0:
        exc = NonFiniteError(
            f"non-finite gradients on {snapshot['nonfinite_steps']} "
            "step(s) under HVD_TPU_NONFINITE_POLICY=abort (the steps "
            "were skipped; optimizer state is intact)")
        # A fatal abort is a black-box event: capture the ring before
        # the raise unwinds the training loop.
        from . import flightrec as flightrec_lib

        flightrec_lib.maybe_dump_for(exc)
        raise exc


# -- divergence detection ----------------------------------------------------

_FP_CHUNKS = 4
_FP_SAMPLE = 8


def fingerprint(tree, chunks: int = _FP_CHUNKS,
                sample: int = _FP_SAMPLE) -> torch.Tensor:
    """Cheap parameter fingerprint: ``chunks`` L2 norms over the fp32
    concatenation of the leaves, then ``sample`` raw values at
    ``linspace(0, n - 1, sample)``; an fp32 vector on the leaves' device.
    Identical replicas give bitwise-identical vectors; a deviation below
    one ulp of its chunk's norm is invisible unless it is sampled."""
    flats = [torch.as_tensor(leaf).detach().reshape(-1).to(torch.float32)
             for leaf in tree_lib.leaves(tree)]
    if not flats:
        return torch.zeros(chunks + sample, dtype=torch.float32)
    flat = flats[0] if len(flats) == 1 else torch.cat(flats)
    n = flat.numel()
    pad = (-n) % chunks
    flat_p = torch.nn.functional.pad(flat, (0, pad)) if pad else flat
    norms = torch.sqrt((flat_p.reshape(chunks, -1) ** 2).sum(dim=1))
    if n:
        idx = np.linspace(0, n - 1, num=sample).astype(np.int64)
        sampled = flat[torch.from_numpy(idx).to(flat.device)]
    else:
        sampled = torch.zeros(sample, dtype=torch.float32,
                              device=flat.device)
    return torch.cat([norms, sampled])


def fingerprint_digest(tree) -> str:
    """crc32 over the fingerprint's fp32 bytes: the exact-comparison form
    :class:`DivergenceDetector` exchanges."""
    fp = fingerprint(tree).cpu().numpy().astype(np.float32)
    return f"{zlib.crc32(fp.tobytes()) & 0xFFFFFFFF:08x}"


def sharded_fingerprint(shards, axes=None) -> torch.Tensor:
    """Fingerprint of a SHARDED state (ZeRO shards, ``zero.py``): each
    rank fingerprints its own shards and the vectors are summed over
    ``axes`` (an axis name, a tuple of them — a route's — or None for the
    world), one all-reduce an axis, so every rank holds the same vector.
    Deterministic in the shard layout and the values: compare it across
    steps or across a checkpoint round trip of the same grid, and a
    resized world through the gathered state."""
    from ..ops import collectives as C

    fp = fingerprint(shards)
    names = (axes,) if axes is None or isinstance(axes, str) else axes
    for name in names:
        fp = C.allreduce(fp, C.Sum, axis=name)
    return fp


def check_divergence(params, tol: float = 0.0) -> Tuple[bool, float]:
    """Cross-rank comparison: the fingerprint's elementwise spread,
    ``max(MAX(fp) - MIN(fp))`` over the ranks (two all-reduces; MAX and
    MIN select, so identical replicas give exactly 0). A non-finite
    spread counts as diverged. Every rank gets the same
    ``(diverged, max_deviation)``."""
    from . import basics
    from ..ops import collectives as C

    fp = fingerprint(params)
    if basics.is_initialized() and basics.size() > 1:
        fp = fp.to(basics.device())
        hi, lo = C.allreduce(fp, C.Max), C.allreduce(fp, C.Min)
    else:
        hi = lo = fp
    max_dev = float((hi - lo).max())
    return (not np.isfinite(max_dev)) or max_dev > tol, max_dev


def resync_params(params, root: int = 0) -> None:
    """The ``resync`` policy: broadcast every parameter tensor from
    ``root`` in place, so the healed replicas are bitwise ``root``'s."""
    from ..ops import collectives as C

    with torch.no_grad():
        for p in tree_lib.tensors(params):
            C.broadcast_(p.data, root)


def divergence_guard(params, step: int, every: int, policy: str = "warn",
                     tol: float = 0.0) -> Tuple[bool, bool]:
    """Periodic divergence check and its policy, called at the TOP of the
    step (before gradients) so that a resync heals the replicas before
    they reach the reduction. ``every <= 0`` disables. ``abort`` acts as
    ``warn`` here (the caller raises through
    :func:`maybe_raise_divergence`). Returns ``(checked, diverged)``, the
    same on every rank."""
    if policy not in DIVERGE_POLICIES:
        raise ValueError(f"unknown divergence policy {policy!r}; known: "
                         f"{DIVERGE_POLICIES}")
    if every <= 0 or step % every:
        return False, False
    diverged, _dev = check_divergence(params, tol)
    if diverged and policy == "resync":
        resync_params(params)
    return True, diverged


def record_divergence(checked, diverged, policy: str = "warn") -> bool:
    """Host accounting of one step's guard flags: bumps
    ``hvd_tpu_divergence_checks_total{result=}`` and, for a resync,
    ``RecoveryStats.divergence_resyncs``. Returns whether a divergence
    was recorded."""
    if not bool(checked):
        return False
    div = bool(diverged)
    _M_DIVERGE.labels(result="diverged" if div else "ok").inc()
    if div:
        logger.warning("integrity: replica parameter divergence "
                       "detected (policy=%s)", policy)
        if policy == "resync":
            _M_DIVERGE.labels(result="resync").inc()
            faults_lib.stats.bump("divergence_resyncs")
    return div


def maybe_raise_divergence(diverged, policy: str, ranks=(),
                           detail: str = "") -> None:
    if policy == "abort" and bool(diverged):
        raise DivergenceError(
            "replica parameters diverged across ranks "
            f"(HVD_TPU_DIVERGE_POLICY=abort)"
            f"{': ' + detail if detail else ''}", ranks=ranks)


class DivergenceDetector:
    """Host-side cross-process divergence detector: every
    ``every_steps`` steps each process takes the crc32 digest of its
    parameters' fingerprint and exchanges it through the controller; a
    minority digest names the offending ranks (the majority wins, ties
    broken by the lexicographically larger digest, so every process
    computes the same majority). Policies: ``warn`` logs, ``abort``
    raises :class:`DivergenceError` naming the ranks, ``resync`` reports
    ``needs_resync`` so the caller re-broadcasts (``broadcast_parameters``
    from rank 0) and counts it in ``RecoveryStats``."""

    def __init__(self, every_steps: Optional[int] = None,
                 policy: Optional[str] = None, controller=None):
        from . import basics

        if every_steps is None:
            cfg = _config()
            every_steps = cfg.diverge_check_steps if cfg is not None \
                else env_int("DIVERGE_CHECK_STEPS", 0)
        self.every_steps = int(every_steps)
        self.policy = resolve_diverge_policy(policy)
        if controller is None and basics.is_initialized():
            controller = basics.context().controller
        self.controller = controller
        self.checks = 0
        self.divergences = 0

    def check(self, params, step: int) -> Optional[dict]:
        """None off-cadence; else a report with ``ok``, ``ranks``
        (offenders), ``digest`` and ``needs_resync``."""
        if self.every_steps <= 0 or step % self.every_steps:
            return None
        self.checks += 1
        digest = fingerprint_digest(params)
        c = self.controller
        if c is None or c.size == 1:
            _M_DIVERGE.labels(result="ok").inc()
            return {"ok": True, "ranks": (), "digest": digest,
                    "needs_resync": False}
        vals = c.exchange("integrity_fp", digest)
        counts = {}
        for v in vals:
            counts[v] = counts.get(v, 0) + 1
        majority = max(counts, key=lambda k: (counts[k], k))
        offenders = tuple(r for r, v in enumerate(vals) if v != majority)
        _M_DIVERGE.labels(result="diverged" if offenders else "ok").inc()
        if not offenders:
            return {"ok": True, "ranks": (), "digest": digest,
                    "needs_resync": False}
        self.divergences += 1
        logger.warning(
            "integrity: parameter fingerprints diverged — ranks %s "
            "disagree with the majority (policy=%s)", list(offenders),
            self.policy)
        if self.policy == "abort":
            raise DivergenceError(
                f"ranks {list(offenders)} hold diverged parameters "
                f"(fingerprint {digest} vs majority {majority})",
                ranks=offenders)
        needs_resync = self.policy == "resync"
        if needs_resync:
            _M_DIVERGE.labels(result="resync").inc()
            faults_lib.stats.bump("divergence_resyncs")
        return {"ok": False, "ranks": offenders, "digest": digest,
                "majority": majority, "needs_resync": needs_resync}


def chaos_poison(tree):
    """The ``nonfinite`` fault site: when the installed plan fires,
    return ``tree`` with the first float leaf (in ``tree.leaves`` order,
    dict keys sorted as JAX orders them) replaced by a copy whose first
    element is NaN (``mode="inf"``: +Inf) — one bad lane on one rank,
    which the guard's agreement must still catch. The input is not
    modified. Without a plan: ``tree`` itself, after one global load."""
    spec = faults_lib.maybe_nonfinite()
    if spec is None:
        return tree
    bad = float("inf") if (spec.mode or "nan") == "inf" else float("nan")
    target = next((x for x in tree_lib.leaves(tree)
                   if isinstance(x, torch.Tensor) and x.is_floating_point()
                   and x.numel()), None)
    if target is None:
        return tree

    def one(x):
        if x is not target:
            return x
        y = x.detach().clone()
        y.view(-1)[0] = bad
        return y

    logger.warning("chaos: poisoned a gradient/batch leaf with %s",
                   "inf" if bad == float("inf") else "nan")
    return tree_lib.map_tree(one, tree)


def chaos_perturb(stacked_tree):
    """The ``diverge`` fault site on a RANK-STACKED tree (leading dim =
    world size): when the plan fires, add ``spec.scale`` (default 1.0)
    times standard normal noise to the slice of rank ``spec.target``
    (default the last) of every float leaf — one silently diverged
    replica. The noise is numpy's ``default_rng(plan seed)``, drawn
    anew for each leaf, as in the JAX package; the input is not
    modified."""
    spec = faults_lib.maybe_diverge()
    if spec is None:
        return stacked_tree
    scale = spec.scale if spec.scale else 1.0
    inj = faults_lib.injector()
    seed = inj.plan.seed if inj is not None else 0

    def one(leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() < 1 \
                or not leaf.is_floating_point():
            return leaf
        exact = leaf.dtype in (torch.float16, torch.float32, torch.float64)
        arr = leaf.detach().to("cpu", leaf.dtype if exact
                               else torch.float32).numpy().copy()
        r = int(spec.target) if spec.target not in (None, "") \
            else arr.shape[0] - 1
        rng = np.random.default_rng(seed)
        arr[r] = arr[r] + scale * rng.standard_normal(
            arr[r].shape).astype(arr.dtype)
        return torch.from_numpy(arr).to(device=leaf.device,
                                        dtype=leaf.dtype)

    logger.warning("chaos: perturbed one replica's parameters "
                   "(scale=%s)", scale)
    return tree_lib.map_tree(one, stacked_tree)
