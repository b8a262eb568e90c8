"""ZeRO stages 1–3 and FSDP: optimizer state, gradients and parameters
sharded over the ranks — the port of ``horovod_tpu/optim.py``
(``auto_shard_threshold``/``should_shard_update`` :756-796, the shard
grid and ``sharded_init``/``sharded_update`` :1748-2066,
``ShardedOptimizer`` :2068-2308, ``FSDPOptimizer`` :2310-2545,
``ZeroOptimizer`` :2546-3364).

The JAX surfaces are optax transforms run inside ``shard_map``; here
each process is one rank and the inner transform is the user's
``torch.optim.Optimizer``: its class and its one parameter group's
hyperparameters are taken and the optimizer is rebuilt over this rank's
SHARDS, one contiguous 1-D slice of each fused bucket of the parameters
(``common/fusion.py``'s plan in flatten order, the JAX plan). A step:

1. fuse each ``p.grad`` into its bucket (cast to the parameter's dtype);
2. reduce-scatter the bucket (SUM or AVERAGE): ``collectives.reducescatter``
   on the flat axis, ``mesh_reducescatter`` down a route's axes (fast
   first, each hop in its wire), or under ``compression="int8_ef"`` the
   quantized reduce-scatter of ``g + residual`` with the key
   ``(0x5EED, step, bucket)`` — kernel K3, one launch a bucket a hop —
   whose local rounding error is the next residual (one full-length fp32
   buffer a bucket on the 4096-block grid, ``_qpad_len``);
3. set each shard's ``.grad``; 4. call the inner ``step()``;
5. all-gather the updated shards (native wires on every hop, the
   route's axes in reverse); 6. copy them into the parameters (stages 1
   and 2), or keep only the shards (stage 3).

The JAX transform all-gathers the UPDATES and each rank applies
``params + updates``; the port all-gathers the updated shard VALUES.
The inner optimizer is elementwise (the only kind these surfaces take,
as in the JAX package), so the owner of each element computes the same
update from the same inputs either way, and every rank ends with the
owner's bits. At n = 2 with ``none`` wires stage 1 is bitwise the
replicated ``DistributedOptimizer`` with the same inner optimizer: a sum
of two terms does not depend on their order. The gathers ride native
wires even where the route has an int8 hop (the JAX package's stage-3
parameter gather and a stateless ``staged_int8`` update gather ride the
route's wires): a gathered parameter is the master value, not a delta a
later step can correct.

Shard grid: ``n`` ranks (the flat axis, or the product of the route's
axis sizes), this rank's chunk at its index — on a route the
fast-axis-major index over the plan's axes, the layout
``mesh_reducescatter`` returns. A bucket of ``L`` elements is padded to
a multiple of ``n * align``: ``align`` is 4096 (whole int8 blocks a
chunk) under ``int8_ef`` or when a hop of the route is int8, else 1.

The non-finite guard (``nonfinite_policy``, ``common/integrity.py``)
wraps the whole step as ``guarded_apply`` does: each fused bucket of
LOCAL gradients goes through ``DistributedOptimizer``'s ``_guard_bucket``
(K1 unscale under ``scale_backoff``, the finite flag, ``zero``'s
sanitize) before its reduction, one MIN all-reduce agrees the flag over
the world, and a skipped step leaves the shards, the inner state, the
EF residual and the step counter untouched, bitwise (its reductions ran
and are dropped). A step from ``accumulate``'s shard gradients (stages 2
and 3) guards what it updates from, the reduced fp32 shard means, as the
JAX ``ZeroOptimizer`` guards its shard gradients: a non-finite addend
of one rank makes the whole reduced element non-finite, so ``zero``
zeroes that element, not only that rank's addend.

The wrapped optimizer's ``param_groups`` stay the one set of
hyperparameters: each inner step first copies them into the inner
group (they must agree across groups), so a learning-rate scheduler
built on the optimizer before it was wrapped, or on the
:class:`ZeroOptimizer` (a ``torch.optim.Optimizer`` whose
``param_groups`` are those same groups), sets the shards' next step.

Stage 2 keeps the accumulated gradient as 1/n fp32 shards: each
microbatch of ``accumulate`` is reduce-scattered on native wires
(exact), summed into its shard, and divided by k; ``step()`` then
updates from the shards with no second reduction, and the EF residual
advances only on a full-gradient step (the JAX package's contract).
Stage 3 frees each parameter's storage at rest (``untyped_storage().
resize_(0)``), so a rank keeps 1/n of the weights between steps;
``gather_params()`` materializes them (one all-gather a bucket) and
``step()`` reduce-scatters, updates the shards and frees the storage
again. ``accumulate`` gathers once per effective step. With
``overlap=True`` (the default, as in the JAX ``ZeroOptimizer``; D2)
the bucket gathers run on the optimizer's
:class:`~.common.overlap.IssueWorker`, in the forward's bucket order (the
order of each bucket's first parameter: the plan is JAX's flatten order
unless ``bucket_order`` pins another; under a reverse plan the forward
walks the buckets from the last to the first). ``accumulate``'s step
allocates the parameters, submits the first bucket's gather and runs
its first microbatch's forward under a ``TorchFunctionMode``: before
any torch function that takes a parameter of a bucket not yet in (a
module's forward, a functional ``F.linear``, a tied head's
``weight.to``) it submits that bucket's and the next bucket's gathers
and waits on that bucket alone — so bucket k+1's all-gather runs under
bucket k's forward, whichever way the model reads its weights. Every
gather still outstanding is finished before this thread issues a
collective of its own (the reduce after the backward, ``step()``,
``gather_state``...). A direct ``gather_params()`` runs the gathers on
the worker too and waits on all of them before it returns. A collective
that the model's forward issues itself (``SyncBatchNorm``, a metric's
``hvd.allreduce``) first waits until the gathers submitted before it
have run (``overlap.drain_before_collective``), so every rank issues it
after the same gathers. The values are ``overlap=False``'s, bitwise;
only the schedule moves. After a failure the elastic restore calls
``abort_step()``: the prefetch, the worker, the kept shard gradients
and (stage 3) the gathered parameters are dropped.

Telemetry: ``hvd_tpu_zero_gather_bytes_total{kind,wire,axis}`` counts,
per call on the host (the JAX metric counts per device at trace time),
``(n - 1) / n`` of each buffer a hop moves — ``kind=grad`` the
reduce-scatter, ``update`` the stage 1/2 gather, ``param`` the stage-3
gather — and ``hvd_tpu_zero_param_bytes_resident{stage}`` the parameter
bytes a rank holds at rest. The JAX ``state_specs``/``shard_specs``
(PartitionSpecs for ``shard_map``) have no counterpart: the shards here
are plain per-process tensors; nor has ``_is_shard_grads``: the
stage-2/3 shard gradients stay inside the optimizer between
``accumulate`` and ``step``; nor have ``FSDPOptimizer.bind``/``unbind``,
which pin a parameter template to the JAX plan: a torch optimizer holds
its parameters from construction.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import math
from typing import Callable, Dict, List, Optional, Sequence

import torch

from . import optim as optim_lib
from .common import basics
from .common import faults as faults_lib
from .common import fusion as fusion_lib
from .common import integrity as integrity_lib
from .common import metrics as metrics_lib
from .common import overlap as overlap_lib
from .checkpoint import Partial, Shard
from .common.config import Config, env_int
from .ops import collectives as C
from .ops.compression import _check_reduce_safe

_METRICS_ON = metrics_lib.enabled()
_M_ZERO_GATHER = metrics_lib.counter(
    "hvd_tpu_zero_gather_bytes_total",
    "bytes moved by the ZeRO sharded-training collectives, ring-accounted "
    "per call on the host ((n-1)/n of each buffer a hop moves): kind=param "
    "is the stage-3 parameter all-gather, kind=grad the gradient "
    "reduce-scatter, kind=update the stage-1/2 all-gather of the updated "
    "shards; wire/axis show which hop carried them",
    labels=("kind", "wire", "axis"))
_M_ZERO_RESIDENT = metrics_lib.gauge(
    "hvd_tpu_zero_param_bytes_resident",
    "at-rest parameter bytes resident per rank under the current ZeRO "
    "stage (stage 3 = 1/N bucket shards; stages 0-2 = full replica)",
    labels=("stage",))
_LINEAR = (C.Average, C.Sum)


# -- the weight-update-sharding heuristic -------------------------------------

def auto_shard_threshold(explicit: Optional[int] = None) -> int:
    """The weight-update-sharding threshold in bytes
    (``init(auto_shard_threshold_bytes=)`` /
    ``HVD_TPU_AUTO_SHARD_THRESHOLD``, default 256 MiB)."""
    if explicit is not None:
        return int(explicit)
    if basics.is_initialized():
        return int(basics.context().config.auto_shard_threshold_bytes)
    return env_int("AUTO_SHARD_THRESHOLD",
                   Config.auto_shard_threshold_bytes)


def should_shard_update(params, size: Optional[int] = None,
                        threshold_bytes: Optional[int] = None) -> bool:
    """True when ZeRO-1 (:class:`ShardedOptimizer`) should be the default
    candidate: the world has more than one rank and the replicated
    parameters take at least :func:`auto_shard_threshold` bytes."""
    if size is None:
        size = basics.size() if basics.is_initialized() else 1
    if size <= 1:
        return False
    if isinstance(params, torch.nn.Module):
        params = list(params.parameters())
    nbytes = sum(t.numel() * t.element_size() for t in params)
    return nbytes >= auto_shard_threshold(threshold_bytes)


# -- the shard grid -----------------------------------------------------------

def _require_axis(axis, what: str):
    """The axis handle the shard grid spans; raises ValueError naming
    ``what`` outside an initialized world or for an axis it lacks."""
    if not basics.is_initialized():
        raise ValueError(f"{what} needs an initialized world (hvd.init()): "
                         "the shard shapes and slices come from its axes")
    return C._axis(axis)


def _route_align(compression, route) -> int:
    """Whole 4096-element int8 blocks a chunk when any hop is quantized:
    by the error-feedback compression or by an int8 wire of the route."""
    if getattr(compression, "error_feedback", False) or (
            route is not None and "int8" in route.wires):
        return C._Q_BLOCK
    return 1


def _grid(axis, route):
    """``(n, index)``: the ranks the grid spans (the JAX
    ``_route_total`` over a route) and this rank's chunk index,
    fast-axis-major over a route's axes."""
    if route is None:
        ax = C._axis(axis)
        return ax.size, ax.index
    n, idx = 1, 0
    for name in route.axis_names:
        ax = C._axis(name)
        n, idx = n * ax.size, idx * ax.size + ax.index
    return n, idx


def _chunk(total: int, n: int, align: int) -> int:
    grid = n * align
    return -(-total // grid) * grid // n


def _shard_of(flat: torch.Tensor, n: int, index: int, align: int):
    """A 1-D bucket -> chunk ``index`` of its padding to a multiple of
    ``n * align`` (with :func:`_grid`, the JAX ``_shard_flat`` and
    ``_mesh_shard_flat``)."""
    padded, _ = fusion_lib.pad_to_multiple(flat, n * align)
    chunk = padded.shape[0] // n
    return padded[index * chunk:(index + 1) * chunk].clone()


def _sharded_route(route):
    """The route as a plan, or None for the flat axis — also where it
    names an axis this world lacks (the JAX trace-time fallback). Only an
    explicit ``route=`` counts: the configured default route never
    changes a sharded state's layout."""
    plan = C.WirePlan.resolve(route)
    if plan is None or not all(a in basics.context().axes
                               for a in plan.axis_names):
        return None
    return plan


def _qpad_len(total_elems: int, n: int) -> int:
    """A bucket's length on the quantized chunk grid (n x 4096)."""
    grid = n * C._Q_BLOCK
    return -(-total_elems // grid) * grid


def _slice_into(leaves: Sequence[torch.Tensor], bucket, start: int,
                out: torch.Tensor) -> torch.Tensor:
    """Copy elements ``[start, start + len(out))`` of the bucket's fused
    leaves into ``out`` (zeros past the bucket's end), without fusing
    the bucket."""
    stop, off = start + out.numel(), 0
    with torch.no_grad():
        out.zero_()
        for i, shape in zip(bucket.leaf_indices, bucket.shapes):
            size = math.prod(shape)
            lo, hi = max(start, off), min(stop, off + size)
            if lo < hi:
                out[lo - start:hi - start].copy_(
                    leaves[i].detach().reshape(-1)[lo - off:hi - off])
            off += size
    return out


def _count_bytes(kind: str, nelems: int, itemsize: int, route, axis,
                 wire: Optional[str] = None) -> None:
    """Ring accounting of one descent or ascent into
    ``hvd_tpu_zero_gather_bytes_total``: ``(n-1)/n`` of the live buffer
    a hop, each hop priced at its wire (``wire`` overrides)."""
    if not _METRICS_ON:
        return
    length = float(nelems)
    phases = [(C._axis(axis).name, wire or "none")] if route is None else \
        [(p.axis, wire or p.wire) for p in route.phases]
    for name, w in phases:
        n = C._axis(name).size
        _M_ZERO_GATHER.labels(kind=kind, wire=w, axis=name).inc(
            (n - 1) / n * length * C._wire_elem_bytes(w, itemsize))
        length /= n


def _hyper(groups) -> dict:
    """The one set of hyperparameters of ``groups`` (every key but
    ``params``). Raises ValueError for groups that differ: a bucket
    mixes parameters of every group."""
    hyper = [{k: v for k, v in g.items() if k != "params"} for g in groups]
    if any(h != hyper[0] for h in hyper[1:]):
        raise ValueError(
            "the sharded optimizers take one parameter group (or groups "
            "with equal hyperparameters): a fused bucket's shard mixes "
            f"parameters of every group; got {len(groups)} groups that "
            "differ")
    return hyper[0]


def _inner_spec(optimizer: torch.optim.Optimizer):
    """The optimizer's class and the constructor keywords of its one
    parameter group (:func:`_hyper`)."""
    cls = type(optimizer)
    accepted = inspect.signature(cls.__init__).parameters
    return cls, {k: v for k, v in _hyper(optimizer.param_groups).items()
                 if k in accepted}


def _all_params(optimizer) -> List[torch.Tensor]:
    return [p for g in optimizer.param_groups for p in g["params"]]


# -- the sharded state --------------------------------------------------------

@dataclasses.dataclass
class _EFShardState:
    """The error feedback of a sharded optimizer (the JAX
    ``_EFShardState`` less its inner state, which the inner optimizer
    holds): this rank's full-length fp32 residual a bucket, on the
    quantized grid, and the stochastic-rounding step counter."""

    residual: List[torch.Tensor]
    step: int = 0


class ShardState:
    """What :func:`sharded_init` builds: the bucket plan, the grid, this
    rank's shards, the inner optimizer over them, the error feedback
    and the guard."""

    # The guard's bucket pass and its agreement are DistributedOptimizer's.
    _guard_bucket = optim_lib._DistributedOptimizerMixin._guard_bucket
    _agree = optim_lib._DistributedOptimizerMixin._agree

    def __init__(self, optimizer, params, axis, threshold, compression,
                 policy, route, order, grad_op, combine_axes=()):
        self.grad_op = C.ReduceOp(grad_op)
        if self.grad_op not in _LINEAR:
            raise ValueError("the sharded optimizers support SUM/AVERAGE")
        self.route = _sharded_route(route)
        self.combine_axes = tuple(combine_axes)
        # The guard agrees over ``axis`` (a parallel spec's dp axis) or,
        # on a route without one, over the world.
        self._axis = _require_axis(
            None if self.route is not None and axis is None else axis,
            "sharded_init")
        self.compression = compression
        self.ef = getattr(compression, "error_feedback", False)
        self.plan = fusion_lib.plan_fusion(params, threshold, order=order)
        self.n, self.index = _grid(axis, self.route)
        self.align = (_route_align(compression, self.route)
                      if self.route is not None
                      else (C._Q_BLOCK if self.ef else 1))
        dev = params[0].device if params else basics.device()
        self.shards = []
        for b in self.plan.buckets:
            chunk = _chunk(b.total_elems, self.n, self.align)
            self.shards.append(_slice_into(
                params, b, self.index * chunk,
                torch.empty(chunk, dtype=b.dtype, device=dev)))
        cls, kw = _inner_spec(optimizer)
        self.inner = cls(self.shards, **kw)
        #: The wrapped optimizer's groups: the one set of hyperparameters.
        self.groups = optimizer.param_groups
        self.ef_state = None
        if self.ef:
            self.ef_state = _EFShardState([
                torch.zeros(_qpad_len(b.total_elems, self.n),
                            dtype=torch.float32, device=dev)
                for b in self.plan.buckets])
        self._scale_cfg = integrity_lib.ScaleConfig.from_env()
        self._guard = None if policy is None else \
            integrity_lib.init_guard_state(policy, self._scale_cfg, dev)
        self._guard_ok = None
        #: Guard agreements run so far, and whether the last step skipped.
        self.guard_agreements = 0
        self.skipped = False

    # -- one step's pieces ---------------------------------------------------

    def start(self, b) -> int:
        """Where this rank's chunk of bucket ``b`` starts."""
        return self.index * _chunk(b.total_elems, self.n, self.align)

    def refresh(self, params) -> None:
        """Re-slice the shards from the (materialized) parameters."""
        for b, s in zip(self.plan.buckets, self.shards):
            _slice_into(params, b, self.start(b), s)

    def sync_hyper(self) -> None:
        """Copy the wrapped optimizer's hyperparameters (a scheduler may
        have set them) into the inner group."""
        self.inner.param_groups[0].update(_hyper(self.groups))

    def push_hyper(self) -> None:
        """Copy the inner group's hyperparameters (a loaded state's) into
        the wrapped optimizer's groups."""
        hyper = {k: v for k, v in self.inner.param_groups[0].items()
                 if k != "params"}
        for g in self.groups:
            g.update(hyper)

    def reduce(self, bi: int, flat: torch.Tensor, exact: bool = False):
        """One bucket of local gradients -> ``(this rank's reduced shard,
        the new EF residual or None)``; the guard's pass first.
        ``exact``: native wires, no guard, no error feedback, the shard as
        fp32 (a microbatch into the stage-2/3 shard accumulator, whose
        sum the step guards)."""
        if flat.is_floating_point():
            # parallel=: slice gradients reassemble (pmean over tp, then
            # sp) before the guard and every reduce-scatter.
            for ax in self.combine_axes:
                flat = C.allreduce(flat, C.Average, axis=ax)
        if self._guard is not None and not exact and \
                flat.is_floating_point():
            flat = self._guard_bucket(flat)
        b = self.plan.buckets[bi]
        itemsize = flat.element_size()
        if self.ef and not exact:
            res = self.ef_state.residual[bi]
            corrected = torch.nn.functional.pad(
                flat.to(torch.float32), (0, res.numel() - flat.numel())) + res
            key = optim_lib._ef_key(self.ef_state.step, bi)
            if self.route is not None:
                shard, r = C.mesh_reducescatter(corrected, self.grad_op,
                                                self.route, key=key,
                                                return_residual=True)
            else:
                shard, r = C.quantized_reducescatter(
                    corrected, self.grad_op, key=key, return_residual=True,
                    axis=self._axis)
            _count_bytes("grad", b.total_elems, itemsize, self.route,
                         self._axis, None if self.route else "int8")
            if self._guard is None:
                # No step can be skipped: the new residual replaces the
                # old one at once (one full-length buffer a bucket).
                r = res.copy_(r)
            return shard.to(b.dtype), r
        padded, _ = fusion_lib.pad_to_multiple(flat, self.n * self.align)
        route = self.route.with_wires("none") \
            if exact and self.route is not None else self.route
        if route is not None:
            shard = C.mesh_reducescatter(padded, self.grad_op, route)
        else:
            shard = C.reducescatter(padded, self.grad_op, self._axis)
        _count_bytes("grad", b.total_elems, itemsize, self.route,
                     self._axis, "none" if exact else None)
        return (shard.to(torch.float32) if exact else shard), None

    def apply(self, g_shards, new_residual=None) -> bool:
        """Agree the guard's flag, then the inner step on the shards and
        the EF advance; returns False for a skipped step (nothing
        moved)."""
        self.skipped = self._guard is not None and self._agree() is False
        if self.skipped:
            return False
        for s, g in zip(self.shards, g_shards):
            s.grad = g.to(s.dtype)
        self.sync_hyper()
        self.inner.step()
        for s in self.shards:
            s.grad = None
        if new_residual is not None:
            self.ef_state.residual = list(new_residual)
            self.ef_state.step += 1
        return True

    def gather(self, t: torch.Tensor, total: int,
               kind: Optional[str] = None) -> torch.Tensor:
        """Every rank's chunk ``t`` of a bucket -> its first ``total``
        values (native wires; a route's axes in reverse). ``kind`` counts
        the bytes into ``hvd_tpu_zero_gather_bytes_total``."""
        if self.route is None:
            full = C.allgather(t, self._axis)
        else:
            full = C.mesh_allgather(t, self.route.reversed().with_wires(
                "none"))
        if kind is not None:
            # An ascent moves what the descent did, hop for hop.
            _count_bytes(kind, total, t.element_size(), self.route,
                         self._axis, "none")
        return full[:total]

    # -- world-size-independent state ----------------------------------------

    def _sum_over_grid(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the grid's ranks, in axis order (rank order on
        the flat axis), so a restore that sums the same addends in rank
        order gets the same bits."""
        names = [self._axis] if self.route is None else \
            list(self.route.axis_names)
        for name in names:
            parts = C.all_gather_stack(t, name)
            t = parts[0].clone()
            for part in parts[1:]:
                t += part
        return t

    def gather_state(self) -> dict:
        """The sharded state as a state that does not depend on the world
        size: each vector state tensor all-gathered exactly and cut to
        its bucket's length, scalars as they are, the EF residuals as
        their sum over the ranks, the guard's snapshot."""
        self.sync_hyper()
        sd = self.inner.state_dict()
        state = {}
        for i, entry in sd["state"].items():
            total = self.plan.buckets[i].total_elems
            state[i] = {k: (self.gather(v, total)
                            if torch.is_tensor(v) and v.dim() else v)
                        for k, v in entry.items()}
        full = {"state": state, "param_groups": sd["param_groups"]}
        if self.ef:
            full["ef_state"] = {
                "step": self.ef_state.step,
                "residual": [self._sum_over_grid(r)[:b.total_elems]
                             for r, b in zip(self.ef_state.residual,
                                             self.plan.buckets)]}
        if self._guard is not None:
            full["guard_state"] = self._guard.snapshot()
        return full

    def reshard_state(self, full: dict) -> None:
        """Load a :meth:`gather_state` result into this world's shards:
        vector state re-sliced on this grid, the summed EF residual on
        grid rank 0 and zeros elsewhere."""
        state = {}
        for i, entry in full["state"].items():
            state[int(i)] = {k: (_shard_of(v, self.n, self.index,
                                           self.align)
                                 if torch.is_tensor(v) and v.dim() else v)
                             for k, v in entry.items()}
        self.inner.load_state_dict({"state": state,
                                    "param_groups": full["param_groups"]})
        self.push_hyper()
        ef = full.get("ef_state")
        if self.ef and ef is not None:
            res = []
            for r, b, mine in zip(ef["residual"], self.plan.buckets,
                                  self.ef_state.residual):
                out = torch.zeros_like(mine)
                if self.index == 0:
                    out[:b.total_elems] = r.to(out.device)
                res.append(out)
            self.ef_state = _EFShardState(res, int(ef["step"]))
        if self._guard is not None and "guard_state" in full:
            self._guard.load(full["guard_state"])


def sharded_init(optimizer: torch.optim.Optimizer, params=None, axis=None,
                 fusion_threshold_bytes: Optional[int] = None,
                 compression=None, nonfinite_policy: Optional[str] = None,
                 route=None, grad_op=C.Average,
                 order=fusion_lib.ORDER_FLATTEN,
                 combine_axes=()) -> ShardState:
    """The sharded state of ``optimizer`` (its class and hyperparameters
    rebuilt over this rank's bucket shards of ``params``, default the
    optimizer's own): see the module docstring. ``compression``,
    ``nonfinite_policy`` and ``route`` decide the state's layout, so the
    state's updates run with them."""
    _require_axis(axis, "sharded_init")
    params = _all_params(optimizer) if params is None else list(params)
    compression = optim_lib._resolve_compression(compression)
    _check_reduce_safe(compression)
    threshold = basics.context().fusion_threshold() \
        if fusion_threshold_bytes is None else int(fusion_threshold_bytes)
    return ShardState(optimizer, params, axis, threshold, compression,
                      integrity_lib.resolve_nonfinite_policy(nonfinite_policy),
                      route, order, grad_op, combine_axes)


def _moved_state(full: dict, old_plan, new_plan) -> dict:
    """A :meth:`ShardState.gather_state` result (vector state cut to each
    bucket's length) moved leaf by leaf from ``old_plan``'s buckets into
    ``new_plan``'s: a new bucket's vector state is its leaves' slices in
    its order, its scalars those of the old bucket of its first leaf
    (every bucket steps together)."""
    vectors: Dict[int, dict] = {}
    scalars: Dict[int, dict] = {}
    for bi, entry in full["state"].items():
        b = old_plan.buckets[int(bi)]
        for k, v in entry.items():
            if torch.is_tensor(v) and v.dim():
                for i, view in fusion_lib.unfuse_bucket(v, b):
                    vectors.setdefault(i, {})[k] = view.reshape(-1)
            else:
                for i in b.leaf_indices:
                    scalars.setdefault(i, {})[k] = v
    state = {}
    for nb, b in enumerate(new_plan.buckets):
        first = b.leaf_indices[0]
        if first not in vectors and first not in scalars:
            continue
        # A tensor scalar (AdamW's step) is stepped in place: one each.
        entry = {k: v.clone() if torch.is_tensor(v) else v
                 for k, v in scalars.get(first, {}).items()}
        for k in vectors.get(first, {}):
            entry[k] = torch.cat([vectors[i][k] for i in b.leaf_indices])
        state[nb] = entry
    groups = [dict(g, params=list(range(len(new_plan.buckets))))
              for g in full["param_groups"]]
    return {"state": state, "param_groups": groups}


def _grad_flat(params, grads, bucket) -> torch.Tensor:
    """A bucket's fused gradients, each cast to its parameter's dtype (a
    missing gradient counts as zeros)."""
    leaves = {}
    for i in bucket.leaf_indices:
        g = grads[i]
        leaves[i] = torch.zeros_like(params[i]) if g is None else \
            (g.to_dense() if g.is_sparse else g).to(params[i].dtype)
    return fusion_lib.fuse_bucket(leaves, bucket)


def sharded_update(state: ShardState, grads, params) -> bool:
    """One ZeRO-1 step on ``state`` with ``grads`` (parallel to
    ``params``): reduce-scatter each bucket, the inner step on the
    shards, all-gather the updated shards into ``params``. Returns False,
    writing nothing, for a step the guard skipped."""
    return _step(state, list(params), grads)


def _step(state: ShardState, params, grads, shard_grads=None,
          stage3: bool = False) -> bool:
    """The one sharded step: reduce-scatter each bucket of ``grads`` (or
    take ``accumulate``'s reduced ``shard_grads``, guarded here), the
    inner step on the shards, and where the parameters are the master
    values (``stage3`` False) re-slice the shards from ``params`` first
    and all-gather the updated shards into them after. Returns False for
    a step the guard skipped (nothing written)."""
    if not stage3:
        state.refresh(params)
    residual = None
    if shard_grads is None:
        # The reduction waits on the grid's peers: the autoscale
        # publisher leaves it out of this rank's busy time.
        dev = state.shards[0].device if state.shards else \
            torch.device("cpu")
        with optim_lib._comm_phase(dev):
            pairs = [state.reduce(bi, _grad_flat(params, grads, b))
                     for bi, b in enumerate(state.plan.buckets)]
        shard_grads = [g for g, _ in pairs]
        if state.ef:
            residual = [r for _, r in pairs]
    elif state._guard is not None:
        shard_grads = [state._guard_bucket(g) for g in shard_grads]
    if not state.apply(shard_grads, residual):
        return False
    if not stage3:
        _write_gathered(state, params, "update")
    return True


def _write_gathered(state: ShardState, params, kind: str) -> None:
    """Gather each bucket and copy it into ``params``, one bucket at a
    time."""
    with torch.no_grad():
        for s, b in zip(state.shards, state.plan.buckets):
            full = state.gather(s, b.total_elems, kind)
            for i, view in fusion_lib.unfuse_bucket(full, b):
                params[i].copy_(view)


# -- the optimizer surfaces -----------------------------------------------------

@dataclasses.dataclass
class _Prefetch:
    """A stage-3 prefetch in flight: the forward's bucket order, which
    bucket holds each parameter, the gathers submitted and not waited
    on, the buckets in, and how far the submissions got."""

    order: List[int]
    bucket_of: dict
    pending: dict = dataclasses.field(default_factory=dict)
    landed: set = dataclasses.field(default_factory=set)
    next: int = 0

    def __post_init__(self):
        self.position = {bi: k for k, bi in enumerate(self.order)}


def _tensor_ids(args, kwargs):
    """The ids of the tensors among a call's arguments (one level into
    lists, tuples and dicts)."""
    out = []
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(id(a))
        elif isinstance(a, (list, tuple)):
            out.extend(id(x) for x in a if isinstance(x, torch.Tensor))
        elif isinstance(a, dict):
            out.extend(id(x) for x in a.values()
                       if isinstance(x, torch.Tensor))
    return out


class _PrefetchMode(torch.overrides.TorchFunctionMode):
    """Waits on a parameter's bucket before the first torch function
    that takes the parameter (see the module docstring)."""

    def __init__(self, opt: "ZeroOptimizer"):
        super().__init__()
        self.opt = opt

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.opt._prefetch is not None:
            self.opt._await_params(_tensor_ids(args, kwargs))
        return func(*args, **kwargs)


def _resident(stage: int, tensors) -> None:
    if _METRICS_ON:
        _M_ZERO_RESIDENT.labels(stage=str(stage)).set(
            sum(t.numel() * t.element_size() for t in tensors))


class ZeroOptimizer(torch.optim.Optimizer):
    """One surface over the ZeRO stages::

        opt = hvd.ZeroOptimizer(torch.optim.AdamW(model.parameters()),
                                zero_stage=3)
        opt.gather_params()                 # stage 3: materialize
        loss_fn(batch).backward()
        opt.step()                          # stage 3: frees them again

    * ``zero_stage=1`` — optimizer state sharded (:class:`ShardedOptimizer`).
    * ``zero_stage=2`` — plus gradient sharding: ``accumulate(loss_fn)``
      returns ``fn(*batch)``, which runs k microbatches and keeps their
      mean gradient as 1/n fp32 shards (each microbatch reduce-scattered
      exactly); the next ``step()`` updates from them. A ``step()`` after
      a plain ``backward()`` is stage 1's.
    * ``zero_stage=3`` — plus parameter sharding: at rest each parameter's
      storage is freed and the shards are the master values;
      ``gather_params()`` materializes the parameters, ``accumulate``
      gathers them once per effective step, and ``step()`` reduces,
      updates the shards and frees the parameters again. ``overlap``
      (default True) runs the gathers on a background worker under the
      forward, a bucket ahead.

    ``compression="int8_ef"``, ``route=`` and ``nonfinite_policy=`` as in
    the module docstring; ``parallel=`` (a ParallelSpec, role dict or
    spec string, the world made with it) spans the shard grid, the
    reduction and the guard over the spec's dp axis alone, through the
    router, after each bucket is pmean-combined over tp then sp: each
    pipeline stage shards over its own dp replicas; ``bucket_order``
    pins the stage-3 plan's leaf order. Elementwise inner optimizers only, one parameter group.
    ``param_groups`` are the wrapped optimizer's own (a scheduler on
    either sets the next step's rate); ``state`` is the inner optimizer's
    over the shards, and ``shard_state`` the whole :class:`ShardState`."""

    def __init__(self, optimizer: torch.optim.Optimizer, zero_stage: int = 2,
                 axis=None, grad_op=C.Average,
                 fusion_threshold_bytes: Optional[int] = None,
                 compression=None, nonfinite_policy: Optional[str] = None,
                 route=None, accum_steps: Optional[int] = None,
                 remat_policy: Optional[str] = None, bucket_order=None,
                 overlap: bool = True, parallel=None):
        #: ``parallel=``: the tp then sp axes every bucket of local
        #: gradients is pmean-combined over before its reduce-scatter.
        combine = ()
        if parallel is not None:
            # The shard grid and the reduction span the spec's dp axis
            # only (through the router: spec.grad_route() unless route=
            # is given), so each pipeline stage and tp/sp coordinate
            # shards over its own dp replicas, and the guard agrees over
            # dp.
            pspec, combine = optim_lib._resolve_parallel(
                parallel, route, None, 0, grad_op)
            if route is None:
                route = pspec.grad_route()
            axis = basics.context().axis(pspec.dp_axes[0])
        # Not Optimizer.__init__: the groups are the wrapped optimizer's
        # and the state is the shards'.
        stage = int(zero_stage)
        if stage not in (1, 2, 3):
            raise ValueError(f"zero_stage must be 1, 2 or 3, got "
                             f"{zero_stage!r} (0/off = the replicated "
                             "DistributedOptimizer)")
        if C.ReduceOp(grad_op) not in _LINEAR:
            raise ValueError("ZeroOptimizer supports SUM/AVERAGE")
        self.zero_stage = stage
        #: What a re-plan rebuilds the sharded state from.
        self._wrapped = optimizer
        self._axis_arg = axis
        self._order = bucket_order if bucket_order is not None \
            else fusion_lib.ORDER_FLATTEN
        self.params = _all_params(optimizer)
        if stage == 3:
            _check_own_storage(self.params)
        self.accum_steps = optim_lib._resolve_accum_steps(accum_steps)
        self.remat_policy = optim_lib.resolve_remat_policy(remat_policy)[0]
        self.shard_state = sharded_init(
            optimizer, self.params, axis, fusion_threshold_bytes,
            compression, nonfinite_policy, route, grad_op, self._order,
            combine)
        self.defaults = optimizer.defaults
        self.param_groups = optimizer.param_groups
        self._shard_grads: Optional[List[torch.Tensor]] = None
        self._materialized = True
        #: D2 (stage 3): the worker the parameter gathers run on, and the
        #: prefetch in flight (None when every bucket is in).
        self.overlap = bool(overlap)
        self._worker: Optional[overlap_lib.IssueWorker] = None
        self._prefetch: Optional[_Prefetch] = None
        #: How the last :meth:`load_sharded_tree` restored: "piecewise"
        #: (this rank's pieces) or "gathered" (by leaf, then resharded).
        self.last_restore: Optional[str] = None
        self._restore_whole = False
        if stage == 3:
            self._free_params()
        else:
            _resident(stage, self.params)

    @property
    def state(self):
        """The inner optimizer's state over this rank's shards."""
        return self.shard_state.inner.state

    def add_param_group(self, param_group) -> None:
        raise ValueError("a sharded optimizer's bucket plan is fixed when "
                         "it is built: wrap an optimizer that holds every "
                         "parameter")

    @property
    def _guard(self):
        """The guard's state (``hvd.current_loss_scale`` and
        ``hvd.observe_guard`` find it here), or None."""
        return self.shard_state._guard

    @property
    def skipped(self) -> bool:
        """Whether the guard skipped the last step."""
        return self.shard_state.skipped

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def gather_state(self) -> dict:
        """This world's state as one that does not depend on the world
        size (:meth:`ShardState.gather_state`): checkpoint it across an
        elastic resize and :meth:`reshard_state` it in the new world,
        which must use the same fusion threshold (the bucket plan)."""
        self._finish_prefetch()
        return self.shard_state.gather_state()

    def reshard_state(self, full: dict) -> None:
        self._finish_prefetch()
        self.shard_state.reshard_state(full)

    def replan(self, fusion_threshold_bytes: Optional[int] = None,
               compression=None, overlap: Optional[bool] = None,
               route=None) -> None:
        """Re-plan the buckets between two steps (``AutotunedStepper``'s
        ``build``), collectively: every rank calls it at the same step.
        The inner state goes through :meth:`gather_state`, moves leaf by
        leaf into the new plan's buckets (at ``fusion_threshold_bytes``,
        None: the context's live threshold; ``compression`` and
        ``route``, when given, re-shape the grid) and
        :meth:`reshard_state`; this rank's int8_ef residual moves leaf by
        leaf, bitwise, and the rounding step and the guard stay. Stage 3
        materializes the parameters for the re-slice and frees them
        after. The D2 worker is drained and closed. Raises between
        ``accumulate`` and ``step()``."""
        if self._shard_grads is not None:
            raise RuntimeError(
                "replan() between two steps only: accumulate() left shard "
                "gradients that step() has not applied")
        self._finish_prefetch()
        if self.zero_stage == 3:
            self._start_gather()
            self._finish_prefetch()
        if self._worker is not None:
            self._worker.drain()
            self._worker.close()
            self._worker = None
        if overlap is not None:
            self.overlap = bool(overlap)
        if fusion_threshold_bytes is None:
            fusion_threshold_bytes = basics.context().fusion_threshold()
        old = self.shard_state
        full = old.gather_state()
        full.pop("ef_state", None)
        full.pop("guard_state", None)
        new = ShardState(
            self._wrapped, self.params, self._axis_arg,
            int(fusion_threshold_bytes),
            old.compression if compression is None
            else optim_lib._resolve_compression(compression),
            None, old.route if route is None else route, self._order,
            old.grad_op, old.combine_axes)
        new.reshard_state(_moved_state(full, old.plan, new.plan))
        new._guard, new._scale_cfg = old._guard, old._scale_cfg
        new.guard_agreements = old.guard_agreements
        if new.ef:
            leaves = {}
            if old.ef:
                for r, b in zip(old.ef_state.residual, old.plan.buckets):
                    for i, view in fusion_lib.unfuse_bucket(
                            r[:b.total_elems], b):
                        leaves[i] = view.reshape(-1)
            for r, b in zip(new.ef_state.residual, new.plan.buckets):
                off = 0
                for i in b.leaf_indices:
                    n = self.params[i].numel()
                    if i in leaves:
                        r[off:off + n] = leaves[i]
                    off += n
            if old.ef:
                new.ef_state.step = old.ef_state.step
        self.shard_state = new
        if self.zero_stage == 3:
            self._free_params()
        else:
            _resident(self.zero_stage, self.params)

    def state_dict(self) -> dict:
        """The inner optimizer's state dict over this rank's shards and,
        where they apply, ``"ef_state"`` (this rank's residuals and the
        rounding step), ``"guard_state"`` and, under stage 3, this rank's
        parameter shards (``"shards"``: at rest the only copy of the
        weights)."""
        st = self.shard_state
        st.sync_hyper()
        sd = st.inner.state_dict()
        if self.zero_stage == 3:
            sd["shards"] = list(st.shards)
        if st.ef:
            sd[optim_lib._EF_STATE] = {"step": st.ef_state.step,
                                       "residual": list(
                                           st.ef_state.residual)}
        if st._guard is not None:
            sd[optim_lib._GUARD_STATE] = st._guard.snapshot()
        return sd

    def load_state_dict(self, state_dict) -> None:
        sd = dict(state_dict)
        ef = sd.pop(optim_lib._EF_STATE, None)
        guard = sd.pop(optim_lib._GUARD_STATE, None)
        shards = sd.pop("shards", None)
        st = self.shard_state
        st.inner.load_state_dict(sd)
        st.push_hyper()
        if shards is not None and self.zero_stage == 3:
            with torch.no_grad():
                for s, v in zip(st.shards, shards):
                    s.copy_(v)
        if guard is not None and st._guard is not None:
            st._guard.load(guard)
        if ef is not None and st.ef:
            mine = st.ef_state.residual
            if len(ef["residual"]) != len(mine) or any(
                    r.numel() != m.numel()
                    for r, m in zip(ef["residual"], mine)):
                raise ValueError("load_state_dict: the error-feedback "
                                 "residuals do not fit this optimizer's "
                                 "shard grid")
            st.ef_state = _EFShardState(
                [r.to(device=m.device, dtype=torch.float32).clone()
                 for r, m in zip(ef["residual"], mine)], int(ef["step"]))

    def sharded_tree(self, names: Optional[Sequence[str]] = None,
                     whole: bool = False) -> dict:
        """This rank's state as pieces for ``checkpoint.save_sharded``,
        keyed by leaf: ``names[i]`` names ``params[i]`` (default its
        index; a pipeline stage passes global names, e.g.
        ``gpt.global_param_names``, so a restore on another pp layout
        finds each leaf in the rank file that wrote it). Each vector
        state tensor is cut into one :class:`~.checkpoint.Shard` a leaf
        (this rank's chunk of the leaf, boxed in the leaf's flat
        coordinates, so a restore can re-cut it for any grid and any
        bucket plan), scalars ride beside them, the EF residuals are
        :class:`~.checkpoint.Partial` addends a leaf (restored on grid
        rank 0), and the parameters come as this rank's chunk too (at
        stages 1 and 2 a copy of the replicated masters: each rank writes
        1/n of them). An optimizer that has not stepped yet gives its
        inner optimizer's state keys, so a fresh one is a restore
        template. ``whole=True`` gives a restore template only: every
        leaf boxed whole, so ``restore_sharded`` returns the gathered,
        world-size-independent state by leaf (the form a changed layout
        goes through; see :meth:`restore_template`)."""
        st = self.shard_state
        names = self._leaf_names(names)
        if self.zero_stage < 3:
            st.refresh(self.params)
        st.sync_hyper()
        sd = st.inner.state_dict()
        hyper = {k: v for k, v in sd["param_groups"][0].items()
                 if k != "params"}
        blank = None
        leaves, params = {}, {}
        for bi, b in enumerate(st.plan.buckets):
            entry = sd["state"].get(bi)
            if entry is None:
                if blank is None:
                    blank = self._blank_state()
                entry = {k: (torch.zeros_like(st.shards[bi], dtype=v.dtype)
                             if torch.is_tensor(v) and v.dim() else v)
                         for k, v in blank.items()}
            for i, a, z, box, n in self._leaf_cuts(bi):
                if whole:
                    a, z, box = 0, 0, (0, n)
                leaves[names[i]] = {
                    k: (Shard(v[a:z], (box,), (n,))
                        if torch.is_tensor(v) and v.dim() else v)
                    for k, v in entry.items()}
                params[names[i]] = Shard(st.shards[bi][a:z], (box,), (n,))
        tree = {"hyper": hyper, "leaves": leaves, "params": params}
        if st.ef:
            res = {}
            for r, b in zip(st.ef_state.residual, st.plan.buckets):
                off = 0
                for i, shape in zip(b.leaf_indices, b.shapes):
                    n = math.prod(shape)
                    res[names[i]] = Partial(r[off:off + n],
                                            primary=st.index == 0)
                    off += n
            tree["ef_state"] = {"step": st.ef_state.step, "residual": res}
        if st._guard is not None:
            tree["guard_state"] = st._guard.snapshot()
        return tree

    def restore_template(self, names: Optional[Sequence[str]] = None):
        """The ``checkpoint.restore_sharded`` template for this optimizer,
        chosen by the checkpoint's layout: where the saved ranks' replica
        groups are this world's (a respec that changed only the dp grid,
        ``shed_dp`` or its way back) each rank restores its pieces
        directly (:meth:`sharded_tree`); where they differ (``fold_pp``:
        the stacked stage leaves change their global shape in the JAX
        package, which restores such a change through ``gather_state``
        and ``reshard_state``) each rank restores the gathered state by
        leaf and reshards it (``whole=True``). The next
        :meth:`load_sharded_tree` loads the form chosen and records it in
        :attr:`last_restore`."""
        from . import checkpoint as ckpt_lib

        def template(groups):
            self._restore_whole = ckpt_lib.layout_changed(groups)
            return self.sharded_tree(names, whole=self._restore_whole)

        return template

    def _leaf_names(self, names) -> List[str]:
        if names is None:
            return [str(i) for i in range(len(self.params))]
        names = [str(n) for n in names]
        if len(names) != len(self.params) or len(set(names)) != len(names):
            raise ValueError(
                f"sharded_tree: {len(names)} names for "
                f"{len(self.params)} parameters (one distinct name each)")
        return names

    def _leaf_cuts(self, bi: int):
        """``(leaf index, chunk start, chunk stop, leaf box, leaf numel)``
        of each leaf of bucket ``bi``: the part of the leaf in this
        rank's chunk (an empty box where they do not meet)."""
        st = self.shard_state
        b = st.plan.buckets[bi]
        start = st.start(b)
        stop = start + st.shards[bi].numel()
        off = 0
        for i, shape in zip(b.leaf_indices, b.shapes):
            n = math.prod(shape)
            lo = min(max(start, off), off + n)
            hi = max(min(stop, off + n), lo)
            a, z = (lo - start, hi - start) if hi > lo else (0, 0)
            yield i, a, z, (lo - off, hi - off), n
            off += n

    def _blank_state(self) -> dict:
        """The per-parameter state the inner optimizer keeps (its keys,
        a vector where it keeps one), from a throwaway copy stepped once
        on one zero element."""
        st = self.shard_state
        cls, kw = _inner_spec(st.inner)
        probe = torch.zeros(1, dtype=st.shards[0].dtype,
                            device=st.shards[0].device, requires_grad=True)
        probe.grad = torch.zeros_like(probe)
        opt = cls([probe], **kw)
        opt.step()
        return dict(opt.state[probe])

    def load_sharded_tree(self, tree: dict,
                          names: Optional[Sequence[str]] = None) -> None:
        """Load what ``checkpoint.restore_sharded`` rebuilt from a
        :meth:`sharded_tree` template (with the same ``names``; either
        form). This rank's pieces go straight into its shards (at stages
        1 and 2 the parameter chunks are then all-gathered into the
        parameters: every rank of the grid calls it together); the
        gathered form goes through :meth:`reshard_state`."""
        st = self.shard_state
        names = self._leaf_names(names)
        whole, self._restore_whole = self._restore_whole, False
        if whole:
            self._load_gathered(tree, names)
            self.last_restore = "gathered"
            return
        self.last_restore = "piecewise"
        state = {}
        for bi, b in enumerate(st.plan.buckets):
            entry = {}
            for i, a, z, _, _ in self._leaf_cuts(bi):
                for k, v in tree["leaves"][names[i]].items():
                    if torch.is_tensor(v) and v.dim():
                        if k not in entry:
                            entry[k] = torch.zeros_like(st.shards[bi],
                                                        dtype=v.dtype)
                        entry[k][a:z] = v
                    elif k not in entry:
                        entry[k] = v      # every bucket steps together
            state[bi] = entry
        groups = [dict(tree["hyper"], params=list(range(len(st.shards))))]
        st.inner.load_state_dict({"state": state, "param_groups": groups})
        st.push_hyper()
        ef = tree.get("ef_state")
        if st.ef and ef is not None:
            res = []
            for r, b in zip(st.ef_state.residual, st.plan.buckets):
                out = torch.zeros_like(r)
                off = 0
                for i, shape in zip(b.leaf_indices, b.shapes):
                    n = math.prod(shape)
                    out[off:off + n] = ef["residual"][names[i]]
                    off += n
                res.append(out)
            st.ef_state = _EFShardState(res, int(ef["step"]))
        if st._guard is not None and "guard_state" in tree:
            st._guard.load(tree["guard_state"])
        with torch.no_grad():
            for bi in range(len(st.shards)):
                st.shards[bi].zero_()
                for i, a, z, _, _ in self._leaf_cuts(bi):
                    st.shards[bi][a:z] = tree["params"][names[i]]
        if self.zero_stage < 3:
            _write_gathered(st, self.params, "param")

    def _load_gathered(self, tree: dict, names: List[str]) -> None:
        """The gathered state by leaf (a ``whole`` template's restore)
        moved into this plan's buckets, as :func:`_moved_state` moves a
        :meth:`gather_state`, and resharded."""
        st = self.shard_state
        full = {"state": {}, "param_groups": [
            dict(tree["hyper"], params=list(range(len(st.shards))))]}
        for bi, b in enumerate(st.plan.buckets):
            first = tree["leaves"][names[b.leaf_indices[0]]]
            full["state"][bi] = {
                k: (torch.cat([tree["leaves"][names[i]][k]
                               for i in b.leaf_indices])
                    if torch.is_tensor(v) and v.dim() else v)
                for k, v in first.items()}
        ef = tree.get("ef_state")
        if ef is not None:
            full["ef_state"] = {"step": ef["step"], "residual": [
                torch.cat([ef["residual"][names[i]] for i in b.leaf_indices])
                for b in st.plan.buckets]}
        if "guard_state" in tree:
            full["guard_state"] = tree["guard_state"]
        st.reshard_state(full)
        with torch.no_grad():
            for bi, b in enumerate(st.plan.buckets):
                flat = torch.cat([tree["params"][names[i]]
                                  for i in b.leaf_indices])
                if self.zero_stage == 3:
                    st.shards[bi].copy_(_shard_of(flat, st.n, st.index,
                                                  st.align))
                else:
                    for i, view in fusion_lib.unfuse_bucket(flat, b):
                        self.params[i].copy_(view)
        if self.zero_stage < 3:
            st.refresh(self.params)

    # -- stage-3 parameter residency -----------------------------------------

    def _require_stage3(self, what: str) -> None:
        if self.zero_stage < 3:
            raise ValueError(f"{what} is the stage-3 surface (parameters "
                             f"stay replicated under zero_stage="
                             f"{self.zero_stage})")

    def rebind(self) -> None:
        """Take the current world's axis handles (after an in-process
        elastic reset destroyed the old groups); the shard grid must not
        change (a resized world goes through :meth:`gather_state` and
        :meth:`reshard_state`)."""
        st = self.shard_state
        if st.route is None:
            st._axis = optim_lib._rebound_axis(st._axis)
        if _grid(st._axis if st.route is None else None, st.route) != \
                (st.n, st.index):
            raise ValueError("rebind: the new world has another shard grid;"
                             " gather_state() before the reset and "
                             "reshard_state() after it")

    def abort_step(self) -> None:
        """Give up the step in progress after a failure (the elastic
        restore calls this before it loads the committed state): the
        prefetch and its worker (which a failed gather latched), the
        kept shard gradients, the gradients, and under stage 3 the
        gathered parameters, freed without waiting on the gathers."""
        if self._worker is not None:
            self._worker.abandon()
            self._worker = None
        self._prefetch = None
        self._shard_grads = None
        for p in self.params:
            p.grad = None
            if self.zero_stage == 3:
                p.untyped_storage().resize_(0)
        if self.zero_stage == 3:
            self._materialized = False
            _resident(3, self.shard_state.shards)

    def _free_params(self) -> None:
        self._finish_prefetch()
        for p in self.params:
            p.grad = None
            p.untyped_storage().resize_(0)
        self._materialized = False
        _resident(3, self.shard_state.shards)

    def shard_params(self) -> List[torch.Tensor]:
        """Stage 3: re-slice this rank's shards from the materialized
        parameters (after the caller changed them, e.g. loaded a model
        state dict) and free the parameters. Returns the shards."""
        self._require_stage3("shard_params")
        self._finish_prefetch()
        if not self._materialized:
            raise ValueError("shard_params needs materialized parameters "
                             "(call gather_params first)")
        self.shard_state.refresh(self.params)
        self._free_params()
        return self.shard_state.shards

    def gather_params(self) -> None:
        """Stage 3: materialize every parameter from the shards (one exact
        all-gather a bucket; under ``overlap`` on the worker, waited on
        before this returns — ``accumulate`` gathers under its forward
        instead, see the module docstring)."""
        self._require_stage3("gather_params")
        self._start_gather()
        self._finish_prefetch()

    def _start_gather(self) -> None:
        """Allocate the parameters and gather them: at once, or under
        ``overlap`` submit the forward's first bucket to the worker."""
        if self._materialized:
            return
        for p in self.params:
            p.untyped_storage().resize_(p.numel() * p.element_size())
        self._materialized = True
        if not self.overlap:
            _write_gathered(self.shard_state, self.params, "param")
            return
        if self._worker is None:
            self._worker = overlap_lib.IssueWorker(
                self.shard_state.shards[0].device
                if self.shard_state.shards else None)
            self._worker.close_with(self)
        buckets = self.shard_state.plan.buckets
        self._prefetch = _Prefetch(
            sorted(range(len(buckets)),
                   key=lambda bi: min(buckets[bi].leaf_indices)),
            {id(self.params[i]): bi for bi, b in enumerate(buckets)
             for i in b.leaf_indices})
        self._issue_upto(0)

    def _gather_bucket(self, bi: int) -> None:
        """One bucket's parameters from the shards (on the worker)."""
        st = self.shard_state
        b = st.plan.buckets[bi]
        full = st.gather(st.shards[bi], b.total_elems, "param")
        with torch.no_grad():
            for i, view in fusion_lib.unfuse_bucket(full, b):
                self.params[i].copy_(view)

    def _issue_upto(self, pos: int) -> None:
        """Submit the gathers of the forward's buckets up to position
        ``pos``, in forward order."""
        pf = self._prefetch
        while pf.next <= min(pos, len(pf.order) - 1):
            bi = pf.order[pf.next]
            pf.pending[bi] = self._worker.submit(self._gather_bucket, bi)
            pf.next += 1

    def _await_params(self, ids) -> None:
        """Before a use of the parameters ``ids``: each of their buckets
        not yet in, in forward order, with the next bucket's gather
        submitted first."""
        pf = self._prefetch
        need = {pf.bucket_of[i] for i in ids if i in pf.bucket_of} \
            - pf.landed
        for bi in sorted(need, key=pf.position.__getitem__):
            self._issue_upto(pf.position[bi] + 1)
            pf.pending.pop(bi).wait()
            pf.landed.add(bi)
        if len(pf.landed) == len(pf.order):
            self._prefetch = None

    def _finish_prefetch(self) -> None:
        """Every outstanding gather submitted and waited on (before this
        thread issues a collective of its own)."""
        pf = self._prefetch
        if pf is None:
            return
        self._issue_upto(len(pf.order))
        for bi in pf.order:
            if bi not in pf.landed:
                pf.pending.pop(bi).wait()
                pf.landed.add(bi)
        self._prefetch = None

    # -- steps ----------------------------------------------------------------

    def step(self, closure=None):
        """Stages 1/2: reduce (or take ``accumulate``'s shard gradients),
        update the shards, gather into the parameters. Stage 3: the same
        without the gather; the parameters are freed after."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._finish_prefetch()
        faults_lib.maybe_collective_fault()
        shard_grads, self._shard_grads = self._shard_grads, None
        _step(self.shard_state, self.params, [p.grad for p in self.params],
              shard_grads, stage3=self.zero_stage == 3)
        if self.zero_stage == 3:
            self._free_params()
        return loss

    def accumulate(self, loss_fn: Callable, has_aux: bool = False):
        """Stage 1: :func:`~.optim.accumulate_gradients`. Stages 2/3:
        ``fn(*batch)`` runs ``accum_steps`` microbatches (the batch split
        along dim 0), reduce-scatters each one's gradients exactly into
        fp32 shard sums, and keeps their mean for the next ``step()``
        (which guards it); stage 3 gathers the parameters first, once.
        Returns the mean loss (and aux)."""
        if self.zero_stage == 1:
            return optim_lib.accumulate_gradients(
                loss_fn, self.accum_steps, self.remat_policy, has_aux)
        _, wrap, saved = optim_lib.resolve_remat_policy(self.remat_policy)
        inner = optim_lib._remat(loss_fn, wrap, saved)
        k = self.accum_steps

        def fn(*batch):
            if self.zero_stage == 3:
                self._start_gather()
            st = self.shard_state
            mbs = [batch] if k == 1 else \
                optim_lib._split_microbatches(batch, k)
            acc = v_sum = aux_sum = value = aux = None
            for mb in mbs:
                # The stage-3 prefetch: the first forward waits on each
                # bucket as it first reads it.
                with _PrefetchMode(self) if self._prefetch is not None \
                        else contextlib.nullcontext():
                    out = inner(*mb)
                value, aux = out if has_aux else (out, None)
                self.zero_grad()
                value.backward()
                self._finish_prefetch()
                grads = [p.grad for p in self.params]
                shards = [st.reduce(bi, _grad_flat(self.params, grads, b),
                                    exact=True)[0]
                          for bi, b in enumerate(st.plan.buckets)]
                acc = shards if acc is None else \
                    [a + s for a, s in zip(acc, shards)]
                self.zero_grad()
                v = value.detach().to(torch.float32)
                v_sum = v if v_sum is None else v_sum + v
                if has_aux:
                    aux_sum = optim_lib._aux_add(aux_sum, aux)
            if k > 1:
                div = torch.full((), float(k), dtype=torch.float32,
                                 device=acc[0].device)
                acc = [a / div for a in acc]
            self._shard_grads = acc
            mean = optim_lib._mean_value(v_sum, k, value)
            if has_aux:
                return mean, optim_lib._aux_mean(aux_sum, aux, k)
            return mean

        return fn


class ShardedOptimizer(ZeroOptimizer):
    """ZeRO-1 (``ZeroOptimizer(zero_stage=1)``): AdamW's moments (any
    elementwise optimizer's state) held as 1/n shards; the parameters
    and their gradients stay replicated::

        opt = hvd.ShardedOptimizer(torch.optim.AdamW(model.parameters()))
        loss.backward()
        opt.step()          # reduce-scatter, shard step, all-gather
        opt.zero_grad()

    ``accumulate(loss_fn)`` is :func:`~.optim.accumulate_gradients` with
    this optimizer's ``accum_steps``/``remat_policy`` (the mean gradient
    in ``p.grad``; then ``step()``)."""

    def __init__(self, optimizer: torch.optim.Optimizer, axis=None,
                 grad_op=C.Average,
                 fusion_threshold_bytes: Optional[int] = None,
                 compression=None, nonfinite_policy: Optional[str] = None,
                 route=None, accum_steps: Optional[int] = None,
                 remat_policy: Optional[str] = None):
        super().__init__(optimizer, zero_stage=1, axis=axis, grad_op=grad_op,
                         fusion_threshold_bytes=fusion_threshold_bytes,
                         compression=compression,
                         nonfinite_policy=nonfinite_policy, route=route,
                         accum_steps=accum_steps, remat_policy=remat_policy)


def _check_own_storage(params) -> None:
    """Stage 3 frees each parameter's storage: each must own all of it."""
    for p in params:
        if (p.storage_offset() or not p.is_contiguous()
                or p.untyped_storage().nbytes()
                != p.numel() * p.element_size()):
            raise ValueError(
                "zero_stage=3 frees each parameter's storage at rest, so "
                "every parameter must own its whole storage (a view of "
                f"another tensor cannot be freed); got a parameter of "
                f"shape {tuple(p.shape)} that does not")


class FSDPOptimizer(ZeroOptimizer):
    """Fully-sharded training (the JAX ``FSDPOptimizer``): stage 3 with
    native wires, no error feedback and no guard — parameters and the
    inner state at 1/n a rank at rest::

        opt = hvd.FSDPOptimizer(torch.optim.AdamW(model.parameters()))
        opt.gather_params(); loss_fn(batch).backward(); opt.step()

    ``init()`` rebuilds the inner optimizer's state from scratch;
    ``update(grads)`` is ``step()`` with given gradients (parallel to the
    parameters)."""

    def __init__(self, optimizer: torch.optim.Optimizer, axis=None,
                 grad_op=C.Average,
                 fusion_threshold_bytes: Optional[int] = None, route=None):
        if C.ReduceOp(grad_op) not in _LINEAR:
            raise ValueError("FSDPOptimizer supports SUM/AVERAGE")
        super().__init__(optimizer, zero_stage=3, axis=axis, grad_op=grad_op,
                         fusion_threshold_bytes=fusion_threshold_bytes,
                         compression="none", nonfinite_policy="off",
                         route=route, accum_steps=1)

    def init(self) -> None:
        """A fresh inner state over the shards."""
        st = self.shard_state
        st.sync_hyper()
        cls, kw = _inner_spec(st.inner)
        st.inner = cls(st.shards, **kw)

    def update(self, grads: Sequence[Optional[torch.Tensor]]):
        """``step()`` with ``grads`` (parallel to the parameters) in place
        of ``p.grad``."""
        for p, g in zip(self.params, grads):
            p.grad = g
        return self.step()
