"""Data-parallel training: ``DistributedOptimizer`` and the parameter /
optimizer-state broadcasts.

The API and architecture are those of the JAX package's own PyTorch
surface (``horovod_tpu/torch/__init__.py``): ``DistributedOptimizer``
returns an instance of a dynamic subclass of the USER's optimizer class
(sharing its ``__dict__``), with a post-accumulate-grad hook on every
trainable parameter, ``backward_passes_per_step`` local aggregation,
``synchronize``/``skip_synchronize`` and the ``zero_grad`` guard. The
reduction is that of ``horovod_tpu/optim.py``'s ``_reduce_tree``: fused
buckets, each compressed, prescaled, summed across ranks, divided by the
world size for AVERAGE, postscaled and decompressed.

Bucketing: the trainable parameters are planned once with
``plan_fusion(order="reverse")`` at the fusion threshold — reverse
parameter order is the order backprop finishes the gradients in, so each
bucket closes as early as it can. When the last gradient of a bucket has
landed (its hook fired the ``backward_passes_per_step``-th time), the
bucket is fused, compressed, prescaled and handed to an asynchronous
``all_reduce(SUM)``; ``synchronize()`` (called by ``step()``) waits on
the handles, divides, postscales, decompresses and unfuses into each
``p.grad``. The collective is issued at every world size, 1 included.
Neither the plan's order nor its bucketing changes the result: every
element is the same sum.

``compression="int8_ef"`` (``horovod_tpu/optim.py`` ``_reduce_tree_ef``):
the plan is stamped with ``fusion.assign_wire_dtypes``. A float bucket
of at least ``quantize_min_bucket_bytes`` reduces ``g + residual``
through ``collectives.quantized_allreduce`` with the stochastic-rounding
key ``(0x5EED, step, bucket)`` (the same on every rank) and keeps the
returned local quantization error as its next residual; a smaller fp32
bucket rides bf16 with no residual; an integer bucket rides as it is.
An int8 bucket's reduction takes several hops (quantize, all_to_all,
dequantize and sum, requantize, all_gather), so it is fused when its
last gradient lands but reduced when ``synchronize()`` reaches it, not
overlapped with backprop as the other buckets are — unless
``overlap=True`` (below). The residual is one fp32 flat buffer per int8
bucket, and the step counter advances once per reduction round, i.e.
once per ``step()``; the new residuals replace the old ones only after
the guard's agreement. Both are this rank's state,
as in the JAX optimizer's ``_EFState``: ``state_dict()`` carries them
under ``"ef_state"`` and ``load_state_dict()`` restores them, so a run
restored from a checkpoint continues as the uninterrupted run would;
``broadcast_optimizer_state`` leaves them out (each rank keeps its own
residual).

``op=Adasum`` grafts the delta-based mixin instead, as the JAX package's
PyTorch surface does (``horovod_tpu/torch/__init__.py``
``_DistributedAdasumMixin``): ``step()`` runs the base optimizer
locally, takes each parameter's delta, rolls the weights back and
applies the Adasum of the deltas (``ops/adasum.py``), one tensor at a
time, so one tensor's coefficients never mix with another's. Adasum is
not linear, so with ``int8_ef`` the deltas ride uncompressed; with
``bf16`` they ride the bf16 wire. Under a non-finite guard ``step()``
first unscales each local gradient (K1, ``scale_backoff``), ANDs its
all-finite flag and agrees it with the one MIN all-reduce, as the JAX
optimizer runs its whole Adasum core under its agreed ``lax.cond``
(``horovod_tpu/optim.py`` ``u_update``); only a good step runs the base
optimizer and reduces the deltas, and a skipped step leaves every
weight, every optimizer tensor and ``p.grad`` as they were. With
``accum_steps=k`` ``accumulate(loss_fn)`` leaves the mean gradient of
the k microbatches in ``p.grad`` and ``step()`` takes one delta step:
one Adasum a parameter per effective step.

``nonfinite_policy`` (``common/integrity.py``) arms the non-finite
guard, in the JAX optimizer's order: when a bucket closes, its fused
LOCAL gradients are unscaled first under ``scale_backoff`` (K1
``scale_buffer`` by ``1 / loss_scale`` rounded to the bucket's dtype),
their all-finite flag is ANDed into one device boolean, and under
``zero`` the non-finite entries become 0, all before compression and
before an int8_ef residual is added. ``synchronize()`` agrees the flag
with one MIN all-reduce of one int32. ``warn`` and ``zero`` never
branch; ``skip_step``, ``scale_backoff`` and ``abort`` read the agreed
flag on the host once a step and, on a bad step, discard the in-flight
results, reduce no int8 bucket (its residual and the rounding step stay
as they were), leave every ``p.grad`` as backprop left it, and
``step()`` does not call the base optimizer. ``state_dict()`` carries
the guard under ``"guard_state"``.

``accum_steps=k`` (with ``remat_policy``) is the JAX optimizer's
scan-based accumulation: ``optimizer.accumulate(loss_fn)`` returns
``fn(*batch)``, which runs ``loss_fn`` on k microbatches (the batch split
along dim 0), each forward and backward in turn, and leaves the MEAN
gradient in ``p.grad`` (an fp32 sum, divided by k, cast back). The
backward hooks launch no bucket before the k-th microbatch, so the
collective round, the guard's agreement and the int8_ef step advance
run once per effective step.

``route`` (``horovod_tpu/optim.py`` ``_resolve_route``; None takes
``init(route=)`` / ``HVD_TPU_ROUTE``) sends every bucket through the
mesh router, ``collectives.mesh_allreduce`` with a
:class:`~.ops.collectives.WirePlan`: an int8_ef bucket reduces ``g +
residual`` with the plan's wires, its key and ``return_residual`` (the
residual keeps the flat path's contract); a small float bucket rides the
same axes in bf16 with no residual, an integer bucket with the wires
``none``; any other float bucket takes the plan as it is (its int8
phases round to nearest); MIN, MAX and PRODUCT reduce over each of the
plan's axes in turn. A routed bucket is fused (and guarded) when its
last gradient lands and reduced at ``synchronize()``, as an int8 bucket
is: its hops run to their end when issued. A plan naming an axis the
world does not have (a flat world) reduces over the flat axis, as the
JAX optimizer does where the plan's axes are not bound. With ``op=Adasum``
each parameter's delta goes through ``mesh_allreduce(op=ADASUM)``: the
Adasum of the fast groups' averages. The guard's agreement runs over
the world either way.

``process_set=`` (a registered :class:`~.process_set.ProcessSet`)
reduces over the set's subgroup alone: averages divide by the set's
size, and a non-member raises ``ValueError``. It does not combine with
``route``.

``zero_stage=1|2|3`` returns a :class:`~.zero.ZeroOptimizer` (ZeRO:
optimizer state, then gradients, then parameters sharded over the ranks;
``zero.py``, whose surfaces this module also exports).

``overlap=True`` (D2, the JAX keyword; ``common/overlap.py``) moves every
bucket's reduction onto the optimizer's :class:`~.common.overlap.
IssueWorker`: when a bucket closes, its whole hop chain — for an int8_ef
bucket quantize (K3), all_to_all, dequantize and sum, requantize,
all_gather; for a routed bucket ``mesh_allreduce``'s phases; for any
other the all-reduce — is submitted, in plan order on every rank (a
bucket that closes early waits for the ones before it), and runs on the
worker's thread and stream while backprop goes on. ``synchronize()``
only waits, agrees the guard's flag and writes the results (and commits
the new residuals on a good step). The values are those of
``overlap=False``, bitwise; a failed hop raises at ``synchronize()``.
A collective of the caller's own (a SyncBatchNorm all-reduce, a metric's
``hvd.allreduce``) waits until the chains submitted before it have run
(``overlap.drain_before_collective``). ``op=Adasum`` accepts the keyword
and runs as without it: its deltas exist only after the base step, when
nothing is left to overlap them with. ``overlap=False`` (the default)
is the synchronous path above.

``replan(fusion_threshold_bytes, compression=, overlap=, route=)``
re-plans a live optimizer between two steps (the ``build`` of
:class:`AutotunedStepper`; the JAX stepper rebuilds a jitted step over
an explicit state, the port moves the state): the old plan's hooks go
and the new plan's are registered, the D2 worker is drained and closed,
the int8_ef residual moves leaf by leaf to its offset in the new buckets
(a leaf outside every int8 bucket keeps its residual for a later plan,
as the JAX per-leaf residual of a bf16 bucket stays), and the rounding
step, the guard and the inner optimizer's state stay; the rounding keys
then use the new bucket indices. A re-plan with a step in progress
raises.

Tracing: while a profiler records (``common/metrics.py`` ``tracing()``),
each bucket runs in the span ``hvd.bucket/<index>/<wire bytes>`` from its
fusing to its issue (an int8_ef, routed or D2 bucket where it is reduced,
in ``_chain``), ``synchronize()`` in ``hvd_step/comm`` and the base
optimizer's update in ``hvd.opt.apply``. The same wire bytes of every
bucket not routed are counted in ``hvd_tpu_allreduce_bytes_total{wire,
axis="flat"}`` (the router counts its own per axis), and a running
timeline gets ``ALLREDUCE`` on ``bucket.<index>``, from the issue to the
result in ``synchronize()``.

The ``collective`` fault site (``common/faults.py``) is consulted once a
reduction round, at ``synchronize()``. After a failure the elastic
restore calls ``abort_step()``, which drops the step in progress (its
issued buckets, counters, guard round and worker); after an in-process
reset ``rebind()`` takes the new world's axis handles.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from .common import autoscale as autoscale_lib
from .common import basics
from .common import config as config_lib
from .common import faults as faults_lib
from .common import fusion as fusion_lib
from .common import integrity as integrity_lib
from .common import metrics as metrics_lib
from .common import overlap as overlap_lib
from .common import tree as tree_lib
from .ops import adasum as adasum_lib
from .ops import collectives as C
from .ops.compression import (BF16Compressor, Compression, Compressor,
                              NoneCompressor, _check_reduce_safe)

_M_EF_NORM = metrics_lib.gauge(
    "hvd_tpu_ef_residual_norm",
    "global L2 norm of the error-feedback quantization residual "
    "(observe_ef_residual)")
_M_PHASE = metrics_lib.histogram(
    "hvd_tpu_step_phase_seconds",
    "per-phase step wall time from StepTimer (grad/comm/apply/...)",
    labels=("phase",))
_METRICS_ON = metrics_lib.enabled()
_M_STEP = metrics_lib.histogram(
    "hvd_tpu_step_seconds",
    "end-to-end training step wall time (AutotunedStepper, blocked)")
_M_REBUILDS = metrics_lib.counter(
    "hvd_tpu_autotune_rebuilds_total",
    "step-function rebuilds triggered by autotuner point moves")


class StepTimer:
    """Host-side step-phase breakdown — the grad/comm/apply split of the
    ``hvd_tpu_step_phase_seconds`` histogram (the JAX package's
    ``StepTimer``). While a profiler records (or with the bridge's
    switch, ``HVD_TPU_METRICS_TRACE=1``, on) each phase is also a
    ``torch.profiler.record_function`` range named ``<name>/<phase>``.
    A ``"comm"`` phase also runs on ``autoscale.comm_clock``: the
    autoscale publisher leaves it out of the rank's step time.

    CUDA work is asynchronous, so a phase measures real work only if its
    outputs are ready when the block exits: :meth:`timed` synchronizes
    the device of every tensor in the result (no host read of a
    value)::

        st = hvd.StepTimer()
        logits = st.timed("forward", model, x)
        with st.phase("grad"):
            loss_fn(logits, y).backward()
            torch.cuda.synchronize()
        opt.step()      # synchronize() times its wait as "comm"

    ``DistributedOptimizer.synchronize()`` times its own wait as
    ``"comm"`` unless the caller already times one. Near zero-cost when
    metrics are disabled and no profiler records (the histogram is the
    no-op singleton and the range one test of the profiler's state; the
    comm clock still runs)."""

    def __init__(self, name: str = "hvd_step"):
        self.name = name

    @contextlib.contextmanager
    def phase(self, phase: str):
        """Context manager timing one named phase. Its range is a
        :func:`~.common.metrics.span`, recorded whenever a profiler
        records, with metrics off too; the histogram opens none."""
        hist = _M_PHASE.labels(phase=phase)
        with contextlib.ExitStack() as stack:
            if phase == "comm":
                stack.enter_context(autoscale_lib.comm_clock.waiting())
            stack.enter_context(metrics_lib.span(f"{self.name}/{phase}"))
            t0 = time.perf_counter()
            try:
                yield
            finally:
                hist.observe(time.perf_counter() - t0)

    def timed(self, phase: str, fn, *args, **kwargs):
        """Run ``fn`` and wait until its outputs are ready on their
        devices, recording the elapsed wall time under ``phase``."""
        with self.phase(phase):
            out = fn(*args, **kwargs)
            _synchronize_devices(out)
        return out


def _synchronize_devices(out) -> None:
    """``torch.cuda.synchronize`` on every CUDA device a tensor of
    ``out`` (any nesting of lists, tuples and dicts) lives on."""
    devices = {t.device for t in tree_lib.leaves(out)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def _comm_phase(device: torch.device):
    """The optimizer's wait on its own collectives: StepTimer's
    ``"comm"`` phase (the range ``hvd_step/comm``), unless the caller
    already times one. While the autoscale publisher measures this
    rank's busy time, the rank's own device work is finished first:
    waiting for it is busy time, not a wait for peers."""
    if autoscale_lib.comm_clock.active():
        yield
        return
    if device.type == "cuda" and autoscale_lib.publishing():
        torch.cuda.synchronize(device)
    with StepTimer().phase("comm"):
        yield


def _timeline():
    """The context's timeline while it records (the optimizer's buckets
    write ``ALLREDUCE`` on ``bucket.<index>``), else None."""
    if not basics.is_initialized():
        return None
    tl = basics.context().timeline
    return tl if tl is not None and tl.active else None


# Base seed of the stochastic rounding: bucket i at step t rounds with the
# key (_EF_SEED, t, i), the same on every rank and on every rerun.
_EF_SEED = 0x5EED
# The state_dict keys of this rank's error-feedback state and of the
# non-finite guard's state.
_EF_STATE = "ef_state"
_GUARD_STATE = "guard_state"


def _ef_key(step: int, bucket_index: int):
    """The stochastic-rounding key of one bucket at one step."""
    return (_EF_SEED, int(step), int(bucket_index))

# How a bucket is reduced (the first field of its record before it is
# issued; an issued synchronous bucket holds its work handle there): an
# int8_ef bucket through the quantized reduction with its residual, any
# other bucket of a routed optimizer through the mesh router, the rest by
# one all-reduce.
_DEFERRED_INT8 = "int8"
_DEFERRED_ROUTED = "routed"
# A bucket whose all-reduce issues at once (under D2: on the worker).
_ISSUED = "issued"
_LINEAR_OPS = (C.Average, C.Sum)


# -- accumulation with remat (horovod_tpu/optim.py:598-755) -----------------

_REMAT_POLICY_NAMES = ("none", "full", "dots", "dots_no_batch")


def resolve_remat_policy(policy: Optional[str] = None):
    """A remat-policy name as ``(name, wrap, saved_ops)``. ``None``
    consults the configured default (``init(remat_policy=)`` /
    ``HVD_TPU_REMAT_POLICY``). Each microbatch loss runs under
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``:
    ``"full"`` recomputes everything in backward; ``"dots"`` saves the
    outputs of ``mm``, ``addmm``, ``bmm`` and ``baddbmm`` and recomputes
    the rest (``create_selective_checkpoint_contexts``);
    ``"dots_no_batch"`` saves ``mm`` and ``addmm`` only."""
    if policy is None:
        cfg = basics.context().config if basics.is_initialized() else None
        policy = cfg.remat_policy if cfg is not None \
            else config_lib.runtime_env("REMAT_POLICY")
    if policy is None or policy in ("none", "off", ""):
        return "none", False, None
    if policy == "full":
        return "full", True, None
    aten = torch.ops.aten
    if policy == "dots":
        return "dots", True, (aten.mm.default, aten.addmm.default,
                              aten.bmm.default, aten.baddbmm.default)
    if policy == "dots_no_batch":
        return "dots_no_batch", True, (aten.mm.default, aten.addmm.default)
    raise ValueError(f"unknown remat policy {policy!r}; choose from "
                     f"{_REMAT_POLICY_NAMES}")


def _resolve_accum_steps(explicit: Optional[int] = None) -> int:
    """None -> the configured default (``init(accum_steps=)`` /
    ``HVD_TPU_ACCUM_STEPS``, else 1); an explicit value wins."""
    if explicit is not None:
        k = int(explicit)
    elif basics.is_initialized():
        k = int(basics.context().config.accum_steps)
    else:
        k = config_lib.env_int("ACCUM_STEPS", 1)
    if k < 1:
        raise ValueError(f"accum_steps must be >= 1, got {k}")
    return k


def _split_microbatches(batch_args, k: int) -> List[Any]:
    """The k microbatches of the batch trees: each tensor leaf ``(b,
    ...)`` viewed as ``(k, b // k, ...)`` and indexed. Raises, naming
    the leaf's shape, when a leading dim does not divide."""
    def split(x):
        x = torch.as_tensor(x)
        if x.dim() == 0 or x.shape[0] % k:
            raise ValueError(
                f"accum_steps={k} does not divide the leading batch dim "
                f"of a batch leaf with shape {tuple(x.shape)}; every batch "
                "array must carry b = k * microbatch rows")
        return x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))

    stacked = tree_lib.map_tree(split, tuple(batch_args))
    return [tree_lib.map_tree(lambda x, i=i: x[i], stacked)
            for i in range(k)]


def _remat(loss_fn: Callable, wrap: bool, saved_ops) -> Callable:
    if not wrap:
        return loss_fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    kw = {"use_reentrant": False}
    if saved_ops is not None:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, list(saved_ops))

    def wrapped(*args):
        return checkpoint(loss_fn, *args, **kw)

    return wrapped


def _graph_params(out: torch.Tensor) -> List[torch.Tensor]:
    """The leaf tensors ``out.backward()`` accumulates into (the
    ``AccumulateGrad`` nodes of its graph), in a fixed order."""
    seen, found, stack = set(), [], [out.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        var = getattr(node, "variable", None)
        if var is not None:
            found.append(var)
        stack.extend(fn for fn, _ in node.next_functions)
    return found


class _Accumulator:
    """The fp32 running sums of one accumulated step: ``add`` takes a
    microbatch's ``p.grad`` into the sum and clears it; ``finish`` leaves
    the mean (the sum divided by k, cast to the parameter's dtype) in
    ``p.grad``. Microbatch i's gradient joins as ``((g0 + g1) + ...)``,
    the JAX scan's order."""

    def __init__(self, k: int):
        self.k = k
        self.index = 0
        self.sums: Dict[torch.Tensor, torch.Tensor] = {}
        self._divisor: Dict[torch.device, torch.Tensor] = {}

    def add(self, p: torch.Tensor) -> None:
        g = p.grad.to(torch.float32)
        prev = self.sums.get(p)
        self.sums[p] = g if prev is None else prev + g
        p.grad = None

    def finish(self, p: torch.Tensor) -> None:
        if p.grad is not None:
            self.add(p)
        total = self.sums.pop(p)
        # A division by a device tensor: PyTorch turns a CUDA tensor's
        # division by a Python scalar into a multiply by its reciprocal.
        div = self._divisor.get(total.device)
        if div is None:
            div = self._divisor[total.device] = torch.full(
                (), float(self.k), dtype=torch.float32, device=total.device)
        p.grad = (total / div).to(p.dtype)


def _mean_value(v_sum: torch.Tensor, k: int, like: torch.Tensor):
    return (v_sum / torch.full((), float(k), dtype=torch.float32,
                               device=v_sum.device)).to(like.dtype)


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _aux_add(acc, new):
    """Float aux leaves summed in fp32; other leaves keep the latest
    microbatch's value."""
    if isinstance(new, dict):
        return type(new)((k, _aux_add(None if acc is None else acc[k], v))
                         for k, v in new.items())
    if isinstance(new, (list, tuple)):
        parts = [_aux_add(None if acc is None else a, v)
                 for a, v in zip(acc if acc is not None else [None] *
                                 len(new), new)]
        return type(new)(*parts) if hasattr(new, "_fields") \
            else type(new)(parts)
    if _is_float(new):
        x = new.detach().to(torch.float32)
        return x if acc is None else acc + x
    return new


def _aux_mean(acc, like, k: int):
    """The float aux sums divided by k, cast to the last microbatch's
    dtypes; the rest as they are."""
    if isinstance(like, dict):
        return type(like)((key, _aux_mean(acc[key], v, k))
                          for key, v in like.items())
    if isinstance(like, (list, tuple)):
        parts = [_aux_mean(a, v, k) for a, v in zip(acc, like)]
        return type(like)(*parts) if hasattr(like, "_fields") \
            else type(like)(parts)
    if _is_float(like):
        return _mean_value(acc, k, like)
    return acc


def _accumulate_run(loss_fn: Callable, k: int, remat: str, has_aux: bool,
                    batch, optimizer=None):
    """One accumulated step (see :func:`accumulate_gradients`); with
    ``optimizer`` (a ``DistributedOptimizer``) its backward hooks take the
    microbatch gradients, so its buckets launch on the k-th."""
    _, wrap, saved_ops = resolve_remat_policy(remat)
    inner = _remat(loss_fn, wrap, saved_ops)

    def split(out):
        return out if has_aux else (out, None)

    if k == 1:
        value, aux = split(inner(*batch))
        value.backward()
        return (value.detach(), aux) if has_aux else value.detach()
    mbs = _split_microbatches(batch, k)
    acc = _Accumulator(k)
    stashed: Dict[torch.Tensor, Optional[torch.Tensor]] = {}
    params: List[torch.Tensor] = []
    v_sum = aux_sum = value = aux = None
    if optimizer is not None:
        optimizer._accum = acc
    try:
        for i, mb in enumerate(mbs):
            acc.index = i
            value, aux = split(inner(*mb))
            if optimizer is None and i == 0:
                # Gradients already in p.grad are kept apart and added
                # back to the mean, as one backward of the fused batch
                # would add to them.
                params = _graph_params(value)
                for p in params:
                    stashed[p], p.grad = p.grad, None
            value.backward()
            if optimizer is None:
                for p in params:
                    if p.grad is not None:
                        acc.add(p)
            v = value.detach().to(torch.float32)
            v_sum = v if v_sum is None else v_sum + v
            if has_aux:
                aux_sum = _aux_add(aux_sum, aux)
    finally:
        if optimizer is not None:
            optimizer._accum = None
    if optimizer is not None:
        optimizer._finish_accumulation(acc)
    else:
        for p in list(acc.sums):
            acc.finish(p)
        for p, old in stashed.items():
            if old is not None:
                p.grad = old if p.grad is None else old + p.grad
    mean = _mean_value(v_sum, k, value)
    if has_aux:
        return mean, _aux_mean(aux_sum, aux, k)
    return mean


def accumulate_gradients(loss_fn: Callable,
                         accum_steps: Optional[int] = None,
                         remat_policy: Optional[str] = None,
                         has_aux: bool = False) -> Callable:
    """Gradient accumulation over microbatches: returns ``fn(*batch)``,
    which splits every tensor of the batch along dim 0 into
    ``accum_steps`` microbatches and runs ``loss_fn(*microbatch)``
    forward and backward on each in turn, so that activation memory
    peaks at one microbatch. It leaves the MEAN of the microbatch
    gradients in ``p.grad`` (added to what was there), computed as the
    JAX package does: an fp32 sum over the microbatches, divided by k,
    cast to the parameter's dtype. A loss that is a mean over its rows
    thus gives the gradient of the fused batch. Returns the mean loss
    (fp32 sum / k), or ``(mean loss, aux)`` with ``has_aux`` (float aux
    leaves averaged, others the last microbatch's).

    ``remat_policy`` (:func:`resolve_remat_policy`) wraps each
    microbatch loss in ``torch.utils.checkpoint``. No collective runs in
    here: with a ``DistributedOptimizer`` use its own
    ``accumulate(loss_fn)`` (``accum_steps=`` on the optimizer), whose
    buckets then launch once per effective step."""
    k = _resolve_accum_steps(accum_steps)
    name, _, _ = resolve_remat_policy(remat_policy)

    def fn(*batch):
        return _accumulate_run(loss_fn, k, name, has_aux, batch)

    return fn


def _resolve_compression(compression) -> type:
    if compression is None:
        compression = basics.context().config.compression
    if compression is None or isinstance(compression, str):
        return Compression.by_name(compression)
    if isinstance(compression, type) and issubclass(compression, Compressor):
        return compression
    raise TypeError(f"compression must be a name or a Compressor class, "
                    f"got {compression!r}")


class _DistributedOptimizerMixin:
    """Methods grafted onto the user's optimizer class."""

    def _dist_init(self, base_cls, named_parameters, op, k, compression,
                   predivide, threshold, quantize_min_bytes,
                   sparse_as_dense, guard_policy=None, scale_cfg=None,
                   accum_k=1, remat_name="none", axis=None, route=None,
                   overlap=False, combine_axes=()):
        self._base_cls = base_cls
        #: ``parallel=``: the tp then sp axes every bucket is
        #: pmean-combined over before the guard and the dp reduction.
        self._combine_axes = tuple(combine_axes)
        #: The axis the buckets reduce over (the world or a process
        #: set's) and the route (a WirePlan, or None for the axis alone).
        self._axis = C._axis(axis)
        self._route = route
        self._sparse_as_dense = sparse_as_dense
        self.op = op
        self._compression = compression
        self._predivide = predivide
        self.backward_passes_per_step = k
        self._should_synchronize = True
        self._dist_dirty = False
        self._dist_params: List[torch.Tensor] = [
            p for group in self.param_groups for p in group["params"]
            if p.requires_grad]
        self._dist_names = {}
        if named_parameters is not None:
            self._dist_names = {id(p): n for n, p in named_parameters}
        self._qmin = quantize_min_bytes
        #: Error feedback (``int8_ef``): per-bucket wires, the residual of
        #: every int8 bucket (one fp32 flat buffer, made at first use), the
        #: residual of a leaf whose bucket is not int8 under the current
        #: plan (kept for a later one: a re-plan moves residuals leaf by
        #: leaf) and the step counter of the stochastic-rounding keys.
        self._ef = getattr(compression, "error_feedback", False)
        self._ef_residual: Dict[int, torch.Tensor] = {}
        self._ef_parked: Dict[int, torch.Tensor] = {}
        self._ef_step = 0
        self._set_plan(threshold)
        self._dist_delay: Dict[int, int] = {}
        self._dist_pending: List[int] = []
        self._dist_inflight: Dict[int, Any] = {}
        #: Bucket allreduces issued so far (every world size, 1 included).
        self.bucket_allreduces = 0
        #: The non-finite guard (None when off): its state, its loss-scale
        #: schedule, this round's local all-finite flag (a device bool)
        #: and whether the last agreed step was skipped.
        self._guard = None
        if guard_policy is not None:
            dev = self._dist_params[0].device if self._dist_params \
                else basics.device()
            self._guard = integrity_lib.init_guard_state(guard_policy,
                                                         scale_cfg, dev)
        self._scale_cfg = scale_cfg
        self._guard_ok: Optional[torch.Tensor] = None
        self._guard_skip = False
        #: Guard agreements run so far (one a reduction round).
        self.guard_agreements = 0
        #: Accumulation: microbatches per effective step, the remat
        #: policy, and the running sums while ``accumulate``'s step runs.
        self.accum_steps = accum_k
        self.remat_policy = remat_name
        self._accum: Optional[_Accumulator] = None
        #: D2: the worker every bucket's chain runs on (made at first
        #: use), the next bucket to submit and the closed buckets waiting
        #: for the ones before them.
        self.overlap = bool(overlap)
        self._worker: Optional[overlap_lib.IssueWorker] = None
        self._reset_counts()
        self._dist_hooks = [
            p.register_post_accumulate_grad_hook(self._hook)
            for p in self._dist_params]

    def _set_plan(self, threshold: int) -> None:
        """Plan the buckets at ``threshold`` (reverse parameter order; the
        int8_ef wires stamped) and index each parameter's bucket."""
        self.fusion_threshold = int(threshold)
        self._dist_plan = fusion_lib.plan_fusion(
            self._dist_params, self.fusion_threshold,
            order=fusion_lib.ORDER_REVERSE)
        if self._ef:
            self._dist_plan = fusion_lib.assign_wire_dtypes(
                self._dist_plan, self._qmin)
        self._bucket_of = {}
        for bi, bucket in enumerate(self._dist_plan.buckets):
            for i in bucket.leaf_indices:
                self._bucket_of[id(self._dist_params[i])] = bi
        # Each bucket's wire: its label and the bytes this rank hands to
        # the reduction, which its span names and the flat byte counter
        # counts (a routed bucket's bytes are the router's, per axis).
        self._wire_bytes, self._wire_counters, counters = [], [], {}
        for bi, bucket in enumerate(self._dist_plan.buckets):
            label, nbytes = C.wire_of(bucket.dtype, bucket.total_elems,
                                      self._wire_compressor(bi),
                                      self._int8_bucket(bi))
            if label not in counters:
                counters[label] = C._M_ALLREDUCE_BYTES.labels(wire=label,
                                                              axis="flat")
            self._wire_bytes.append(nbytes)
            self._wire_counters.append(None if self._route is not None
                                       else counters[label])

    def _bucket_span(self, bi: int):
        """Bucket ``bi``'s span ``hvd.bucket/<index>/<wire bytes>`` while
        a profiler records, else the no-op."""
        if not metrics_lib.tracing():
            return metrics_lib.NOOP.time()
        return metrics_lib.span(f"hvd.bucket/{bi}/{self._wire_bytes[bi]}")

    def _issued(self, bi: int) -> None:
        """Bucket ``bi`` handed to its reduction: the flat byte counter,
        and the timeline's begin while one records."""
        counter = self._wire_counters[bi]
        if counter is not None:
            counter.inc(self._wire_bytes[bi])
        tl = _timeline()
        if tl is not None:
            tl.begin(f"bucket.{bi}", "ALLREDUCE")

    def replan(self, fusion_threshold_bytes: Optional[int] = None,
               compression=None, overlap: Optional[bool] = None,
               route=None) -> None:
        """Re-plan the buckets of this live optimizer between two steps
        (``AutotunedStepper``'s ``build``): at ``fusion_threshold_bytes``
        (None: the context's live threshold), and with ``compression``,
        ``overlap`` and ``route`` when given (None keeps each). The hooks
        of the old plan are removed and the new plan's registered, so no
        gradient is reduced twice; the D2 worker is drained and closed;
        the int8_ef residual moves leaf by leaf (each parameter's slice
        lands at its offset in its new bucket, bitwise), and the rounding
        step, the guard's state and loss scale and the inner optimizer's
        state stay. The stochastic-rounding keys then take the new
        plan's bucket indices. Raises with buckets in flight, a
        ``backward_passes_per_step`` round half done or an
        ``accumulate`` step running."""
        if self._dist_dirty or self._dist_inflight or self._ov_ready \
                or self._accum is not None:
            raise RuntimeError(
                "replan() between two steps only: this optimizer has a "
                "step in progress (gradients counted or buckets in flight "
                "since the last step()/synchronize())")
        if fusion_threshold_bytes is None:
            fusion_threshold_bytes = basics.context().fusion_threshold()
        leaves = self._ef_by_leaf()
        if compression is not None:
            compressor = _resolve_compression(compression)
            _check_reduce_safe(compressor)
            self._compression = compressor
            self._ef = getattr(compressor, "error_feedback", False)
        if route is not None:
            self._route = _resolve_route(route)
        if self._worker is not None:
            self._worker.drain()
            self._worker.close()
            self._worker = None
        if overlap is not None:
            self.overlap = bool(overlap)
        for h in self._dist_hooks:
            h.remove()
        self._set_plan(fusion_threshold_bytes)
        self._ef_residual, self._ef_parked = self._place_residuals(leaves)
        self._reset_counts()
        self._dist_hooks = [
            p.register_post_accumulate_grad_hook(self._hook)
            for p in self._dist_params]

    def _ef_by_leaf(self) -> Dict[int, torch.Tensor]:
        """This rank's error-feedback residual by parameter index (flat
        fp32): each leaf's slice of its int8 bucket's residual, or its
        kept one."""
        out = dict(self._ef_parked)
        for bi, r in self._ef_residual.items():
            for i, view in fusion_lib.unfuse_bucket(
                    r, self._dist_plan.buckets[bi]):
                out[i] = view.reshape(-1)
        return out

    def _place_residuals(self, leaves: Dict[int, torch.Tensor]):
        """Leaf residuals -> ``(residual by int8 bucket, kept leaves)``
        under the current plan: a bucket none of whose leaves has one
        keeps none (made at first use, as before); a leaf without one
        in a bucket that has one gets zeros."""
        residual, placed = {}, set()
        for bi, bucket in enumerate(self._dist_plan.buckets):
            if not self._int8_bucket(bi) or not any(
                    i in leaves for i in bucket.leaf_indices):
                continue
            parts = [leaves[i] if i in leaves else torch.zeros(
                         self._dist_params[i].numel(), dtype=torch.float32,
                         device=self._dist_params[i].device)
                     for i in bucket.leaf_indices]
            residual[bi] = parts[0].clone() if len(parts) == 1 \
                else torch.cat(parts)
            placed.update(bucket.leaf_indices)
        return residual, {i: r.clone() for i, r in leaves.items()
                          if i not in placed}

    def _reset_counts(self) -> None:
        self._dist_delay = {id(p): self.backward_passes_per_step
                            for p in self._dist_params}
        self._dist_pending = [len(b.leaf_indices)
                              for b in self._dist_plan.buckets]
        self._ov_next = 0
        self._ov_ready: Dict[int, tuple] = {}

    def rebind(self) -> None:
        """Take the current world's handle of this optimizer's axis
        (after an in-process elastic reset destroyed the old groups)."""
        self._axis = _rebound_axis(self._axis)

    def abort_step(self) -> None:
        """Give up the step in progress after a failure (the elastic
        restore calls this before it loads the committed state): the
        buckets issued or waiting, the delay counters, the guard's round
        and the D2 worker (which a failed hop latched) are dropped, and
        so are the abandoned step's gradients (``p.grad`` None). The
        next backward starts a fresh step."""
        if self._worker is not None:
            self._worker.abandon()
            self._worker = None
        self._dist_inflight.clear()
        self._reset_counts()
        self._dist_dirty = False
        self._guard_ok = None
        self._guard_skip = False
        self._accum = None
        for p in self._dist_params:
            p.grad = None

    def _check_sparse_grad(self, p: torch.Tensor) -> None:
        if (p.grad is not None and p.grad.is_sparse
                and not self._sparse_as_dense):
            raise ValueError(
                "DistributedOptimizer got a sparse gradient; pass "
                "sparse_as_dense=True (densify + allreduce) or "
                "reduce it yourself via sparse_allreduce_async")

    def _hook(self, p: torch.Tensor) -> None:
        # Checked before the delay counter moves, so that a retried
        # backward raises the same error.
        self._check_sparse_grad(p)
        acc = self._accum
        if acc is not None:
            # accumulate(): microbatches before the k-th only add to the
            # running sum; the k-th leaves the mean and closes buckets.
            if acc.index < acc.k - 1:
                acc.add(p)
                return
            acc.finish(p)
        self._count(p)

    def _count(self, p: torch.Tensor) -> None:
        pid = id(p)
        if self._dist_delay[pid] <= 0:
            raise AssertionError(
                f"Gradients of {self._dist_names.get(pid, 'a parameter')} "
                "were computed more than backward_passes_per_step times "
                "before call to step(). Increase backward_passes_per_step "
                "to accumulate gradients locally.")
        self._dist_dirty = True
        self._dist_delay[pid] -= 1
        if self._dist_delay[pid] == 0:
            bi = self._bucket_of[pid]
            self._dist_pending[bi] -= 1
            if self._dist_pending[bi] == 0:
                self._launch(bi)

    def _wire_compressor(self, bi: int):
        """The compressor bucket ``bi`` rides: the user's, or under
        ``int8_ef`` bf16 for a small float bucket and none for the rest
        (an int8 bucket is reduced by :meth:`_reduce_int8` instead)."""
        if not self._ef:
            return self._compression
        wire = self._dist_plan.wire_dtypes[bi]
        return BF16Compressor if (wire == fusion_lib.WIRE_BF16
                                  and self.op in _LINEAR_OPS) \
            else NoneCompressor

    def _int8_bucket(self, bi: int) -> bool:
        """Bucket ``bi`` takes the error-feedback quantized reduction."""
        return (self._ef and self.op in _LINEAR_OPS
                and self._dist_plan.wire_dtypes[bi] == fusion_lib.WIRE_INT8)

    def _finish_accumulation(self, acc: _Accumulator) -> None:
        """After ``accumulate``'s k-th microbatch: a parameter whose
        gradient the k-th backward did not reach still gets its mean and
        its count."""
        for p in list(acc.sums):
            acc.finish(p)
            self._count(p)

    def accumulate(self, loss_fn: Callable, has_aux: bool = False
                   ) -> Callable:
        """:func:`accumulate_gradients` bound to this optimizer's
        ``accum_steps`` and ``remat_policy``: ``fn(*batch)`` leaves the
        mean gradient in ``p.grad`` and launches every bucket once, on
        the last microbatch; then call ``step()``."""
        def fn(*batch):
            return _accumulate_run(loss_fn, self.accum_steps,
                                   self.remat_policy, has_aux, batch,
                                   optimizer=self)

        return fn

    def _guard_bucket(self, flat: torch.Tensor) -> torch.Tensor:
        """The non-finite guard on one fused bucket of LOCAL gradients:
        unscale (``scale_backoff``, K1 with ``1 / loss_scale`` rounded to
        the bucket's dtype), AND its all-finite flag into this round's,
        and under ``zero`` replace non-finite entries with 0."""
        policy = self._guard.policy
        if policy == "scale_backoff":
            flat = C._apply_scale(flat, float(integrity_lib.inverse_scale(
                self._guard)))
        finite = torch.isfinite(flat)
        ok = finite.all()
        self._guard_ok = ok if self._guard_ok is None \
            else torch.logical_and(self._guard_ok, ok)
        if policy == "zero":
            flat = torch.where(finite, flat, torch.zeros_like(flat))
        return flat

    def _agree(self) -> Optional[bool]:
        """This round's flag agreed across ranks: one MIN all-reduce of
        one int32. Under the skipping policies the agreed flag is read on
        the host (the step's one device-to-host read) and returned; under
        ``warn``/``zero`` the counters advance on the device and None is
        returned."""
        local = self._guard_ok
        self._guard_ok = None
        dev = self._guard.nonfinite_steps.device \
            if isinstance(self._guard.nonfinite_steps, torch.Tensor) \
            else basics.device()
        flag = (torch.ones(1, dtype=torch.int32, device=dev)
                if local is None else local.reshape(1).to(torch.int32))
        flag = C.allreduce(flag, C.Min, axis=self._axis)
        self.guard_agreements += 1
        if self._guard.policy in integrity_lib.SKIPPING_POLICIES:
            ok = bool(flag.item())
            integrity_lib.advance(self._guard, ok, self._scale_cfg)
            return ok
        integrity_lib.advance(self._guard, flag[0] > 0, self._scale_cfg)
        return None

    def _launch(self, bi: int) -> None:
        """Fuse, guard, compress, prescale and issue bucket ``bi``'s SUM,
        in its span; an int8_ef or routed bucket is only fused (and
        guarded) here and reduced, in its span, at :meth:`synchronize`,
        and under D2 every bucket is reduced, in its span, on the
        worker."""
        deferred = (self.overlap or self._route is not None
                    or self._int8_bucket(bi))
        with metrics_lib.NOOP.time() if deferred else self._bucket_span(bi):
            self._fuse_and_issue(bi)

    def _fuse_and_issue(self, bi: int) -> None:
        bucket = self._dist_plan.buckets[bi]
        grads = {}
        for i in bucket.leaf_indices:
            p = self._dist_params[i]
            if p.grad is None:
                # A parameter backprop did not reach contributes zeros.
                p.grad = torch.zeros_like(p)
            if p.grad.is_sparse:
                self._check_sparse_grad(p)
                p.grad = p.grad.to_dense()
            grads[i] = p.grad
        flat = fusion_lib.fuse_bucket(grads, bucket)
        if flat.is_floating_point():
            # parallel=: slice gradients reassemble (pmean over tp, then
            # sp) before everything downstream — the guard, the
            # compression and the dp reduction all see exact gradients.
            for ax in self._combine_axes:
                flat = C.allreduce(flat, C.Average, axis=ax)
        if self._guard is not None and flat.is_floating_point():
            flat = self._guard_bucket(flat)
        self.bucket_allreduces += 1
        if self._int8_bucket(bi):
            rec = (_DEFERRED_INT8, flat, None)
        else:
            wire, ctx = self._wire_compressor(bi).compress(flat)
            if self._predivide != 1.0:
                wire = C._apply_scale(wire, 1.0 / self._predivide)
            rec = (_DEFERRED_ROUTED if self._route is not None
                   else _ISSUED, wire, ctx)
        if self.overlap:
            self._submit_in_order(bi, rec)
            return
        if rec[0] == _ISSUED:
            self._issued(bi)
            rec = (C._allreduce_async_inplace(rec[1], self._sum_op(),
                                              self._axis),) + rec[1:]
        self._dist_inflight[bi] = rec

    def _sum_op(self):
        return C.Sum if self.op in _LINEAR_OPS else self.op

    def _submit_in_order(self, bi: int, rec: tuple) -> None:
        """D2: submit every closed bucket whose predecessors in the plan
        are submitted, so every rank issues the chains in plan order."""
        self._ov_ready[bi] = rec
        if self._worker is None:
            self._worker = overlap_lib.IssueWorker(rec[1].device)
            self._worker.close_with(self)
        while self._ov_next in self._ov_ready:
            nb = self._ov_next
            kind, wire, ctx = self._ov_ready.pop(nb)
            self._dist_inflight[nb] = (self._worker.submit(
                self._chain, nb, kind, wire, ctx), wire, ctx)
            self._ov_next += 1

    def _chain(self, bi: int, kind, wire: torch.Tensor, ctx):
        """Bucket ``bi``'s whole reduction (on the worker under D2, at
        ``synchronize()`` otherwise): ``(reduced gradients, new residual
        or None)``. Reads the residual and step; commits nothing. A
        bucket reduced here (any under D2, an int8_ef or routed one
        otherwise) is issued in its span."""
        if not isinstance(kind, str):
            kind.wait()         # the work handle issued in _launch
            return self._finish_bucket(bi, wire, ctx), None
        with self._bucket_span(bi):
            self._issued(bi)
            if kind == _DEFERRED_INT8:
                return self._reduce_int8(bi, wire)
            if kind == _DEFERRED_ROUTED:
                wire = self._reduce_routed(wire)
            else:
                C._allreduce_async_inplace(wire, self._sum_op(),
                                           self._axis).wait()
        return self._finish_bucket(bi, wire, ctx), None

    def _finish_bucket(self, bi: int, wire: torch.Tensor, ctx):
        """A reduced SUM wire -> the bucket's gradients: the average's
        division (or predivide's postscale), then decompression."""
        if self.op == C.Average:
            if self._predivide != 1.0:
                wire = C._apply_scale(wire, self._predivide
                                      / self._axis.size)
            else:
                wire = C._divide_by_size(wire, self._axis.size)
        return self._wire_compressor(bi).decompress(wire, ctx)

    def _reduce_routed(self, w: torch.Tensor) -> torch.Tensor:
        """The route's reduction of a non-int8 bucket: the SUM through
        the mesh router (integer buckets, and an int8_ef optimizer's
        small buckets, with the wires ``none``), or MIN/MAX/PRODUCT over
        each of the plan's axes in turn."""
        if self.op not in _LINEAR_OPS:
            for name in self._route.axis_names:
                w = C.allreduce(w, self.op, axis=name)
            return w
        plan = self._route if (w.is_floating_point() and not self._ef) \
            else self._route.with_wires("none")
        return C.mesh_allreduce(w, C.Sum, plan)

    def _reduce_int8(self, bi: int, flat: torch.Tensor):
        """The error-feedback quantized reduction of bucket ``bi``: reduce
        ``g + residual`` through ``quantized_allreduce``; returns the
        reduced gradients and the local error, the next residual (in
        unscaled gradient units), which ``synchronize()`` commits."""
        res = self._ef_residual.get(bi)
        corrected = flat.to(torch.float32)
        if res is not None:
            corrected = corrected + res
        op, post = self.op, 1.0
        if self._predivide != 1.0:
            corrected = corrected * (1.0 / self._predivide)
            op, post = C.Sum, self._predivide / self._axis.size
        key = _ef_key(self._ef_step, bi)
        if self._route is not None:
            y, res = C.mesh_allreduce(corrected, op, self._route, key=key,
                                      return_residual=True)
        else:
            y, res = C.quantized_allreduce(corrected, op, key=key,
                                           return_residual=True,
                                           axis=self._axis)
        if self._predivide != 1.0:
            res = res * self._predivide
        return C._apply_scale(y, post).to(flat.dtype), res

    def synchronize(self) -> None:
        """Reduce every bucket not yet issued (a parameter mid-aggregation
        or without a gradient included), wait for all of them and write
        the reduced gradients into ``p.grad``; under ``int8_ef`` commit
        the new residuals and advance the rounding step (a step the guard
        skips commits nothing)."""
        if not self._dist_dirty and not self._dist_inflight:
            return
        with _comm_phase(self._dist_params[0].device):
            self._synchronize()

    def _synchronize(self) -> None:
        faults_lib.maybe_collective_fault()
        for bi in range(len(self._dist_plan.buckets)):
            if bi not in self._dist_inflight and bi not in self._ov_ready:
                self._launch(bi)
        done = {}
        # The timeline's bucket ends as each bucket's result arrives.
        tl = _timeline()
        end = (lambda bi: tl.end(f"bucket.{bi}", "ALLREDUCE")) \
            if tl is not None else (lambda bi: None)
        if self.overlap:
            # Every chain, in plan order; a failed hop raises here.
            for bi in sorted(self._dist_inflight):
                done[bi] = self._dist_inflight[bi][0].wait()
                end(bi)
        if self._guard is not None and self._agree() is False:
            # A globally agreed bad step: finish the bucket collectives
            # every rank issued, discard their results, reduce no int8
            # bucket (residual and rounding step unchanged) and leave
            # p.grad as backprop left it; step() skips the update.
            if not self.overlap:
                for bi, (work, _, _) in self._dist_inflight.items():
                    if not isinstance(work, str):
                        work.wait()
                        end(bi)
            self._dist_inflight.clear()
            self._reset_counts()
            self._dist_dirty = False
            self._guard_skip = True
            return
        self._guard_skip = False
        if not self.overlap:
            for bi in sorted(self._dist_inflight):
                done[bi] = self._chain(bi, *self._dist_inflight[bi])
                end(bi)
        for bi in sorted(done):
            flat, res = done[bi]
            for i, view in fusion_lib.unfuse_bucket(
                    flat, self._dist_plan.buckets[bi]):
                self._dist_params[i].grad.copy_(view)
            if res is not None:
                self._ef_residual[bi] = res
        self._dist_inflight.clear()
        self._reset_counts()
        self._dist_dirty = False
        if self._ef:
            self._ef_step += 1

    def state_dict(self):
        """The base optimizer's state dict and, under ``int8_ef``, this
        rank's error-feedback state: ``"ef_state": {"step": int,
        "residual": {bucket index: fp32 flat residual},
        "fusion_threshold": the plan's threshold}`` (plus ``"parked"``,
        the residuals of leaves outside the plan's int8 buckets, by
        parameter index, when there are any); with a non-finite guard
        its counters and loss scale under ``"guard_state"``. A dict saved
        before a :meth:`replan` loads after it: its residuals move leaf
        by leaf from the plan of its threshold."""
        sd = self._base_cls.state_dict(self)
        if self._ef or self._ef_parked:
            sd[_EF_STATE] = {"step": self._ef_step,
                             "residual": dict(self._ef_residual),
                             "fusion_threshold": self.fusion_threshold}
            if self._ef_parked:
                sd[_EF_STATE]["parked"] = dict(self._ef_parked)
        if self._guard is not None:
            sd[_GUARD_STATE] = self._guard.snapshot()
        return sd

    def load_state_dict(self, state_dict) -> None:
        """The base optimizer's ``load_state_dict`` and, where the dict
        carries them, the guard's state and this rank's error-feedback
        state (residuals copied onto their buckets' device)."""
        sd = dict(state_dict)
        ef = sd.pop(_EF_STATE, None)
        guard = sd.pop(_GUARD_STATE, None)
        self._base_cls.load_state_dict(self, sd)
        if guard is not None and self._guard is not None:
            self._guard.load(guard)
        if ef is None or not self._ef:
            return
        # The residual was saved under the plan of its fusion threshold
        # (a dict without one: this optimizer's): its buckets' leaves
        # land at their offsets in this plan's buckets.
        saved = self._dist_plan
        threshold = ef.get("fusion_threshold", self.fusion_threshold)
        if int(threshold) != self.fusion_threshold:
            saved = fusion_lib.assign_wire_dtypes(fusion_lib.plan_fusion(
                self._dist_params, int(threshold),
                order=fusion_lib.ORDER_REVERSE), self._qmin)
        buckets = saved.buckets
        leaves = {int(i): r.to(device=self._dist_params[int(i)].device,
                               dtype=torch.float32).reshape(-1)
                  for i, r in ef.get("parked", {}).items()}
        for bi, r in ef["residual"].items():
            bi = int(bi)
            if not 0 <= bi < len(buckets) \
                    or r.numel() != buckets[bi].total_elems:
                raise ValueError(
                    f"load_state_dict: error-feedback residual of bucket "
                    f"{bi} ({r.numel()} elements) does not fit the "
                    f"{len(buckets)} buckets of the plan at fusion "
                    f"threshold {threshold}")
            dev = self._dist_params[buckets[bi].leaf_indices[0]].device
            r = r.to(device=dev, dtype=torch.float32)
            for i, view in fusion_lib.unfuse_bucket(r, buckets[bi]):
                leaves[i] = view.reshape(-1)
        self._ef_residual, self._ef_parked = self._place_residuals(leaves)
        self._ef_step = int(ef["step"])

    def skip_synchronize(self):
        """Context manager: ``step()`` without synchronizing (after an
        explicit ``synchronize()``)."""

        @contextlib.contextmanager
        def ctx():
            self._should_synchronize = False
            try:
                yield
            finally:
                self._should_synchronize = True

        return ctx()

    def step(self, closure=None):
        """Synchronize (unless inside ``skip_synchronize``), then the base
        optimizer's step (the span ``hvd.opt.apply``), which a step the
        guard skipped does not run."""
        if self._should_synchronize:
            self.synchronize()
        if self._guard_skip:
            self._guard_skip = False
            return None
        with metrics_lib.span("hvd.opt.apply"):
            return self._base_cls.step(self, closure)

    def zero_grad(self, set_to_none: bool = True):
        if self._dist_dirty or self._dist_inflight:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() "
                "but before optimizer.step() or optimizer.synchronize(). "
                "This is prohibited as it can cause a race condition.")
        return self._base_cls.zero_grad(self, set_to_none=set_to_none)


class _DistributedAdasumMixin:
    """Delta-based Adasum methods grafted onto the user's optimizer class
    (the JAX package's torch surface, ``_DistributedAdasumMixin``), with
    the non-finite guard and accumulation of the JAX optimizer's Adasum
    core (see the module docstring)."""

    # The guard's pass over one gradient and its agreement are
    # DistributedOptimizer's.
    _guard_bucket = _DistributedOptimizerMixin._guard_bucket
    _agree = _DistributedOptimizerMixin._agree

    def _dist_init(self, base_cls, named_parameters, wire, axis=None,
                   route=None, guard_policy=None, scale_cfg=None,
                   accum_k=1, remat_name="none", overlap=False,
                   combine_axes=()):
        self._base_cls = base_cls
        self._adasum_wire = wire
        #: ``parallel=``: the tp then sp axes each gradient is
        #: pmean-combined over before the guard and the base step.
        self._combine_axes = tuple(combine_axes)
        self._axis = C._axis(axis)
        self._route = route
        self._dist_names = {}
        if named_parameters is not None:
            self._dist_names = {id(p): n for n, p in named_parameters}
        #: Per-tensor Adasum reductions run so far.
        self.adasum_reductions = 0
        self._guard = None
        if guard_policy is not None:
            params = self._all_params()
            dev = params[0].device if params else basics.device()
            self._guard = integrity_lib.init_guard_state(guard_policy,
                                                         scale_cfg, dev)
        self._scale_cfg = scale_cfg
        self._guard_ok: Optional[torch.Tensor] = None
        self._guard_skip = False
        #: Guard agreements run so far (one a step).
        self.guard_agreements = 0
        self.accum_steps = accum_k
        self.remat_policy = remat_name
        #: Accepted and changes nothing: every delta exists only after
        #: the base step, so there is nothing left to overlap them with.
        self.overlap = bool(overlap)

    def _all_params(self) -> List[torch.Tensor]:
        return [p for group in self.param_groups for p in group["params"]]

    def replan(self, fusion_threshold_bytes: Optional[int] = None,
               compression=None, overlap: Optional[bool] = None,
               route=None) -> None:
        """Adasum reduces one tensor at a time: a fusion threshold has no
        plan to move. ``overlap`` is recorded (and changes nothing, as at
        construction); ``route`` takes the new plan."""
        if compression is not None:
            raise ValueError("replan(compression=) on an Adasum optimizer: "
                             "its wire is fixed when it is built")
        if overlap is not None:
            self.overlap = bool(overlap)
        if route is not None:
            self._route = _resolve_route(route)

    def rebind(self) -> None:
        """Take the current world's handle of this optimizer's axis."""
        self._axis = _rebound_axis(self._axis)

    def abort_step(self) -> None:
        """Give up the step in progress after a failure: the guard's
        round and the abandoned step's gradients (``p.grad`` None)."""
        self._guard_ok = None
        self._guard_skip = False
        for p in self._all_params():
            p.grad = None

    def accumulate(self, loss_fn: Callable, has_aux: bool = False
                   ) -> Callable:
        """:func:`accumulate_gradients` with this optimizer's
        ``accum_steps`` and ``remat_policy``: ``fn(*batch)`` leaves the
        mean gradient of the microbatches in ``p.grad``; then ``step()``
        takes one delta step."""
        return accumulate_gradients(loss_fn, self.accum_steps,
                                    self.remat_policy, has_aux)

    def _guarded(self, params) -> bool:
        """The guard on the local gradients, in the JAX core's order:
        unscale each (K1 under ``scale_backoff``), AND its finite flag,
        sanitize under ``zero``; agree the flag with one MIN all-reduce.
        Returns False for a step the agreement skips, leaving every
        ``p.grad`` as it was; else sets the guarded gradients."""
        grads = [p for p in params
                 if p.grad is not None and p.grad.is_floating_point()]
        guarded = [self._guard_bucket(p.grad) for p in grads]
        ok = self._agree()
        self._guard_skip = ok is False
        if self._guard_skip:
            return False
        for p, g in zip(grads, guarded):
            p.grad = g
        return True

    def _reduce_delta(self, delta: torch.Tensor) -> torch.Tensor:
        """The Adasum of every rank's ``delta``: over the axis, or through
        the mesh router (the Adasum of the fast groups' averages)."""
        if self._route is None:
            return adasum_lib.adasum_allreduce(delta, wire=self._adasum_wire,
                                               axis=self._axis)
        w = delta.to(torch.bfloat16) if self._adasum_wire == "bf16" \
            else delta
        return C.mesh_allreduce(w, C.Adasum, self._route).to(delta.dtype)

    def step(self, closure=None):
        """The guard (when armed), then the base optimizer's step on the
        local gradients, then every parameter's delta replaced by the
        Adasum of all ranks' deltas. A step the guard skips returns None
        and changes nothing."""
        params = self._all_params()
        faults_lib.maybe_collective_fault()
        if self._combine_axes:
            # parallel=: slice gradients reassemble (pmean over tp, then
            # sp) before everything downstream, as in the JAX core.
            for p in params:
                if p.grad is not None and p.grad.is_floating_point():
                    for ax in self._combine_axes:
                        p.grad = C.allreduce(p.grad, C.Average, axis=ax)
        if self._guard is not None and not self._guarded(params):
            return None
        with torch.no_grad():
            before = [p.detach().clone() for p in params]
        result = self._base_cls.step(self, closure)
        with torch.no_grad(), _comm_phase(
                params[0].device if params else torch.device("cpu")):
            for p, b in zip(params, before):
                p.copy_(b + self._reduce_delta(p.detach() - b))
                self.adasum_reductions += 1
        return result


def _rebound_axis(axis):
    """``axis``'s handle in the current world (the world, or the mesh
    axis of its name); a process set's axis must be registered anew."""
    ctx = basics.context()
    if axis.name == ctx.world_axis.name:
        return ctx.world_axis
    if axis.name in ctx.axes:
        return ctx.axes[axis.name]
    raise ValueError(f"rebind: axis {axis.name!r} is not part of the new "
                     "world; register the process set again and build a "
                     "new optimizer")


def _graft(optimizer: torch.optim.Optimizer, mixin) -> Any:
    """An instance of a dynamic subclass of the user's optimizer class
    with ``mixin``'s methods, sharing the optimizer's ``__dict__``."""
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               {k_: v for k_, v in mixin.__dict__.items()
                if not k_.startswith("__")})
    obj = cls.__new__(cls)
    obj.__dict__.update(optimizer.__dict__)  # share param_groups + state
    return obj


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression=None,
                         backward_passes_per_step: int = 1,
                         op: C.ReduceOp = C.Average,
                         gradient_predivide_factor: float = 1.0,
                         fusion_threshold_bytes: Optional[int] = None,
                         quantize_min_bucket_bytes: Optional[int] = None,
                         process_set=None,
                         sparse_as_dense: bool = False,
                         nonfinite_policy: Optional[str] = None,
                         accum_steps: Optional[int] = None,
                         remat_policy: Optional[str] = None,
                         route=None,
                         zero_stage: int = 0,
                         overlap: bool = False,
                         parallel=None):
    """Wrap ``optimizer`` so ``step()`` first averages (``op=Average``) or
    sums (``op=Sum``) the gradients across ranks, in fused buckets, or
    (``op=Adasum``) reduces the optimizer's per-parameter deltas by
    Adasum.

    ``compression`` is None (``HVD_TPU_COMPRESSION``, default none),
    ``"none"``/``"fp16"``/``"bf16"``/``"int8_ef"`` or a Compressor class;
    ``"int8"`` is a wire format that cannot ride a sum and raises.
    ``backward_passes_per_step=k`` accumulates k local backward passes
    (summed in ``p.grad``, as PyTorch accumulates) before the reduction
    (not with Adasum). ``gradient_predivide_factor`` f splits the average
    around the sum (1/f before, f/n after) and requires ``op=Average``.
    ``fusion_threshold_bytes`` defaults to the ``init()`` setting
    (``HVD_TPU_FUSION_THRESHOLD``, 64 MiB), ``quantize_min_bucket_bytes``
    (the smallest bucket ``int8_ef`` quantizes) likewise
    (``HVD_TPU_QUANTIZE_MIN_BYTES``, 64 KiB). ``sparse_as_dense=True``
    densifies a sparse gradient (``nn.Embedding(sparse=True)``) before it
    enters its bucket; with False a sparse gradient raises.

    ``nonfinite_policy`` (None: ``init(nonfinite_policy=)`` /
    ``HVD_TPU_NONFINITE_POLICY``; ``"off"`` disables) arms the non-finite
    guard (``common/integrity.py``); ``accum_steps`` (None: the
    configured default, 1) and ``remat_policy`` set up
    ``optimizer.accumulate(loss_fn)``. ``accum_steps > 1`` and
    ``backward_passes_per_step > 1`` are two spellings of accumulation
    and raise together.

    ``op`` may also be Min, Max or Product (elementwise over ranks).
    ``route`` (None: ``init(route=)`` / ``HVD_TPU_ROUTE``) reduces
    through the mesh router, ``process_set`` over a registered set's
    ranks alone (see the module's docstring).

    ``overlap=True`` runs the reduction on a background worker in plan
    order (D2; values unchanged, see the module docstring).

    ``zero_stage`` 1, 2 or 3 returns ``zero.ZeroOptimizer(optimizer,
    zero_stage, ...)`` with this call's op, threshold, compression,
    guard, route, accumulation and overlap. It refuses
    ``backward_passes_per_step != 1`` and a predivide factor other than
    1, as the JAX package refuses them, and ``process_set``.

    ``parallel`` (a ParallelSpec, a role dict or a spec string; explicit
    only, as in the JAX package) reduces over the spec's ``dp`` axis
    alone, through the mesh router (``spec.grad_route()`` unless
    ``route=`` is given), after every bucket is pmean-combined over
    ``tp`` and then ``sp`` (``parallel.tensor_parallel.
    combine_slice_grads``); ``pp`` and ``ep`` gradients are this rank's
    own, as in the JAX package (a pipeline stage's shared gradients are
    already summed over ``pp`` by ``pipeline_accumulate_gradients``). A
    ``dp=1`` spec binds a one-rank dp axis whose reduction is a no-op.
    With ``zero_stage`` the spec goes to ``ZeroOptimizer(parallel=)``;
    with ``op=Adasum`` each gradient is combined over tp then sp before
    the guard and the base step, and each delta's Adasum runs through
    the router over dp (``mesh_allreduce(op=ADASUM)``, the JAX route).
    The world must have been made with the same spec
    (``init(parallel=)``); the spec needs a dp axis, and ``route=``, if
    given, must run over exactly the dp axes."""
    op = C.ReduceOp(op)
    pspec, combine_axes = _resolve_parallel(parallel, route, process_set,
                                            zero_stage, op)
    if zero_stage:
        if int(zero_stage) not in (1, 2, 3):
            raise ValueError(f"zero_stage must be 0 (off), 1, 2 or 3 — got "
                             f"{zero_stage!r}")
        if int(backward_passes_per_step) != 1:
            raise ValueError(
                "zero_stage composes with accum_steps / route / "
                "compression / nonfinite_policy, not with the "
                "backward_passes_per_step aggregation")
        if gradient_predivide_factor != 1.0:
            raise ValueError("gradient_predivide_factor is not supported "
                             "on the ZeRO sharded surfaces — fold the "
                             "scale into your loss")
        if process_set is not None:
            raise ValueError("zero_stage shards over the world's axes, not "
                             "a process set")
        from .zero import ZeroOptimizer

        return ZeroOptimizer(
            optimizer, zero_stage=int(zero_stage), grad_op=op,
            fusion_threshold_bytes=fusion_threshold_bytes,
            compression=compression, nonfinite_policy=nonfinite_policy,
            route=route, accum_steps=accum_steps, remat_policy=remat_policy,
            overlap=overlap, parallel=pspec)
    if gradient_predivide_factor != 1.0 and op != C.Average:
        raise ValueError("gradient_predivide_factor requires op=Average")
    axis = None
    if process_set is not None:
        process_set.engine      # registered, and this rank a member
        axis = process_set.axis
    plan = _resolve_route(route) if pspec is None or route is not None \
        else pspec.grad_route()
    if pspec is not None:
        # Without a route= the reduction runs through the mesh router over
        # the dp axis, not the flat allreduce: the router stamps the
        # per-axis byte counter (hvd_tpu_allreduce_bytes_total{axis="dp"})
        # and pins the plan, so the HVD_TPU_ROUTE default cannot apply.
        axis = basics.context().axis(pspec.dp_axes[0])
    if plan is not None and process_set is not None:
        raise ValueError("route= and process_set= do not combine: a route "
                         "runs over the world's mesh axes")
    k = int(backward_passes_per_step)
    if k < 1:
        raise ValueError(f"backward_passes_per_step must be >= 1, got {k}")
    cfg = basics.context().config
    compressor = _resolve_compression(compression)
    _check_reduce_safe(compressor)
    accum_k = _resolve_accum_steps(accum_steps)
    # Resolved once here: a later knob change must not re-shape the
    # accumulation of a live optimizer.
    remat_name, _, _ = resolve_remat_policy(remat_policy)
    if accum_k > 1 and k > 1:
        raise ValueError(
            "accum_steps and backward_passes_per_step are two spellings "
            "of gradient accumulation — pick one (accum_steps is the "
            "microbatched accumulate(); backward_passes_per_step the "
            "call-per-microbatch aggregation)")
    guard_policy = integrity_lib.resolve_nonfinite_policy(nonfinite_policy)
    scale_cfg = integrity_lib.ScaleConfig.from_env()
    if op == C.Adasum:
        if k != 1:
            raise NotImplementedError(
                "backward_passes_per_step > 1 is not supported with "
                "op=Adasum (accumulate locally by skipping zero_grad "
                "between backwards instead)")
        if issubclass(compressor, BF16Compressor):
            wire = "bf16"
        elif compressor is NoneCompressor or getattr(
                compressor, "quantized_reduce", False):
            wire = "none"       # Adasum is not linear: deltas ride as is
        else:
            raise ValueError(f"op=Adasum takes compression none, bf16 or "
                             f"int8_ef, got {compressor.__name__}")
        obj = _graft(optimizer, _DistributedAdasumMixin)
        obj._dist_init(optimizer.__class__, named_parameters, wire, axis,
                       plan, guard_policy, scale_cfg, accum_k, remat_name,
                       overlap, combine_axes)
        return obj
    threshold = basics.context().fusion_threshold() \
        if fusion_threshold_bytes is None else int(fusion_threshold_bytes)
    qmin = cfg.quantize_min_bucket_bytes if quantize_min_bucket_bytes is None \
        else int(quantize_min_bucket_bytes)
    obj = _graft(optimizer, _DistributedOptimizerMixin)
    obj._dist_init(optimizer.__class__, named_parameters, op, k, compressor,
                   float(gradient_predivide_factor), threshold, qmin,
                   bool(sparse_as_dense), guard_policy, scale_cfg, accum_k,
                   remat_name, axis, plan, overlap, combine_axes)
    return obj


def _resolve_parallel(parallel, route, process_set, zero_stage, op):
    """``(spec, combine axes)`` of a ``parallel=`` value, with the JAX
    package's checks; ``(None, ())`` without one."""
    if parallel is None:
        return None, ()
    from .parallel.spec import ParallelSpec

    pspec = ParallelSpec.resolve(parallel)
    if not pspec.dp_axes:
        raise ValueError(
            f"parallel spec {pspec.describe()!r} has no dp axis — with "
            "nothing to reduce over, wrap the optimizer directly")
    if process_set is not None:
        raise ValueError("parallel= and process_set= do not combine: the "
                         "spec's dp axis is the reduction's scope")
    if route is not None:
        rt = C.WirePlan.resolve(route)
        if rt is not None and set(rt.axis_names) != set(pspec.dp_axes):
            raise ValueError(
                f"route axes {rt.axis_names} must be exactly the parallel "
                f"spec's dp axes {pspec.dp_axes} — gradients reduce over "
                "dp only (tp and sp combine via pmean)")
    ctx = basics.context()
    if ctx.parallel_spec is None or \
            ctx.parallel_spec.describe() != pspec.describe():
        raise ValueError(
            f"DistributedOptimizer(parallel={pspec.describe()!r}) needs "
            "the world made with the same spec: init(parallel=...) or "
            f"HVD_TPU_PARALLEL (this world's: "
            f"{ctx.parallel_spec.describe() if ctx.parallel_spec else None})")
    combine = tuple(ctx.axis(a) for a in (pspec.tp_axis, pspec.sp_axis)
                    if a is not None)
    return pspec, combine


class _GradSlots(torch.optim.Optimizer):
    """A gradient tree's slots as the parameters of an optimizer whose
    step does nothing: what :func:`DistributedGradFn` wraps in a
    ``DistributedOptimizer`` to reduce a tree with its machinery."""

    def __init__(self, slots):
        super().__init__(slots, {})

    def step(self, closure=None):
        return None


@dataclasses.dataclass
class GradFnEFState:
    """:func:`DistributedGradFn`'s error-feedback state under ``int8_ef``:
    the residual of each int8 bucket (fp32 flat, by bucket index; a
    bucket without one starts from zeros) and the stochastic-rounding
    step."""

    residual: Dict[int, torch.Tensor]
    step: int = 0


def DistributedGradFn(grad_fn: Callable,
                      op: C.ReduceOp = C.Average,
                      compression=None,
                      fusion_threshold_bytes: Optional[int] = None,
                      has_value: bool = False,
                      reduce_value: bool = True,
                      overlap: bool = False,
                      quantize_min_bucket_bytes: Optional[int] = None,
                      nonfinite_policy: Optional[str] = None,
                      route=None,
                      accum_steps: Optional[int] = None,
                      remat_policy: Optional[str] = None,
                      process_set=None):
    """The DistributedGradientTape analog (the JAX package's
    ``DistributedGradFn``): wraps ``grad_fn``, a callable that returns a
    tree of gradient tensors (or ``(value, grads)`` with
    ``has_value=True``), so that the tree comes back reduced across the
    ranks: in fused buckets, with the compression, the route, the
    non-finite guard and ``overlap`` of a :func:`DistributedOptimizer`,
    whose machinery reduces it (the tree's leaves are the slots of a
    ``DistributedOptimizer`` over an optimizer that does not step). The
    value is averaged across the ranks when ``reduce_value``.

    ``accum_steps`` (explicit only: it changes what ``grad_fn`` is) makes
    ``grad_fn`` the LOSS, called as ``loss(params, *batch)``: the wrapper
    splits the batch arguments into k microbatches along their leading
    dim, takes the mean gradient with respect to ``params`` (a tree of
    tensors that require grad; their ``.grad`` is left as it was) under
    ``remat_policy``, and reduces it once::

        gfn = hvd.DistributedGradFn(loss, accum_steps=4, has_value=True)
        loss, grads = gfn(params, x, y)        # x, y rows = 4 * mb

    With ``compression="int8_ef"`` the wrapped function takes an
    ``ef_state=`` keyword (a :class:`GradFnEFState`,
    ``wrapped.init_ef_state()``; None starts from a zero residual) and
    returns ``(result, new_ef_state)``. ``nonfinite_policy`` (explicit
    only: it changes the returns) adds a ``guard_state=`` keyword
    (``wrapped.init_guard_state()``) and appends the new guard state to
    the returns; an agreed non-finite step returns zero gradients and
    leaves the residual and the rounding step as they were. ``op``
    Average or Sum (Min, Max, Product elementwise); ``process_set``
    reduces over a registered set's ranks."""
    from torch.utils import _pytree as pytree

    compressor = _resolve_compression(compression)
    _check_reduce_safe(compressor)
    ef = getattr(compressor, "error_feedback", False)
    accum_k = int(accum_steps) if accum_steps is not None else 1
    if accum_k < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_k}")
    if accum_k == 1 and remat_policy is not None:
        raise ValueError(
            "remat_policy on DistributedGradFn requires accum_steps > 1: "
            "remat wraps the LOSS, which this surface only owns under the "
            "microbatch split (use torch.utils.checkpoint in your loss "
            "otherwise)")
    remat_name, _, _ = resolve_remat_policy(remat_policy)
    produces_value = has_value or accum_k > 1
    policy = integrity_lib.resolve_nonfinite_policy(nonfinite_policy) \
        if nonfinite_policy is not None else None
    scale_cfg = integrity_lib.ScaleConfig.from_env()
    plan = _resolve_route(route)
    built: Dict[tuple, Any] = {}

    def optimizer_for(grads):
        sig = tuple((tuple(g.shape), g.dtype, g.device) for g in grads)
        if sig not in built:
            slots = [torch.zeros_like(g).requires_grad_() for g in grads]
            opt = DistributedOptimizer(
                _GradSlots(slots), compression=compressor, op=op,
                fusion_threshold_bytes=fusion_threshold_bytes,
                quantize_min_bucket_bytes=quantize_min_bucket_bytes,
                process_set=process_set, nonfinite_policy=policy or "off",
                route=plan, overlap=overlap)
            for h in opt._dist_hooks:
                h.remove()
            built[sig] = (opt, slots)
        return built[sig]

    def grads_of(args, kwargs):
        if accum_k == 1:
            out = grad_fn(*args, **kwargs)
            return out if produces_value else (None, out)
        params, batch = args[0], args[1:]
        leaves = pytree.tree_leaves(params)
        stashed = [p.grad for p in leaves]
        for p in leaves:
            p.grad = None
        try:
            value = _accumulate_run(
                lambda *mb: grad_fn(params, *mb, **kwargs), accum_k,
                remat_name, False, batch)
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in leaves]
        finally:
            for p, g in zip(leaves, stashed):
                p.grad = g
        return value, pytree.tree_unflatten(grads,
                                            pytree.tree_structure(params))

    def reduce_value_(opt, val):
        if not reduce_value or val is None:
            return val
        if opt._route is not None:
            return pytree.tree_map(lambda v: C.mesh_allreduce(
                v, C.Average, opt._route.with_wires("none")), val)
        return pytree.tree_map(
            lambda v: C.allreduce(v, C.Average, axis=opt._axis), val)

    def wrapped(*args, ef_state=None, guard_state=None, **kwargs):
        val, grads = grads_of(args, kwargs)
        leaves, spec = pytree.tree_flatten(grads)
        opt, slots = optimizer_for(leaves)
        for s, g in zip(slots, leaves):
            s.grad = g.detach().clone()
        if ef:
            st = ef_state or GradFnEFState({})
            opt._ef_residual = {int(b): r.clone()
                                for b, r in st.residual.items()}
            opt._ef_step = int(st.step)
        if policy is not None:
            opt._guard.load((guard_state or wrapped.init_guard_state())
                            .snapshot())
        opt._dist_dirty = True
        opt.synchronize()
        skipped, opt._guard_skip = opt._guard_skip, False
        reduced = pytree.tree_unflatten(
            [torch.zeros_like(s.grad) if skipped else s.grad.clone()
             for s in slots], spec)
        for s in slots:
            s.grad = None
        result = (reduce_value_(opt, val), reduced) if has_value \
            else reduced
        out = (result,)
        if ef:
            out += (GradFnEFState(dict(opt._ef_residual), opt._ef_step),)
        if policy is not None:
            new = integrity_lib.init_guard_state(
                policy, scale_cfg, opt._guard.nonfinite_steps.device
                if torch.is_tensor(opt._guard.nonfinite_steps) else None)
            new.load(opt._guard.snapshot())
            out += (new,)
        return out[0] if len(out) == 1 else out

    wrapped.init_ef_state = lambda *_: GradFnEFState({})
    if policy is not None:
        wrapped.init_guard_state = lambda: integrity_lib.init_guard_state(
            policy, scale_cfg)
    return wrapped


class AutotunedStepper:
    """Drives the runtime autotuner from real step timings and rebuilds
    the step whenever the tuned point moves (the JAX package's
    ``AutotunedStepper``; Horovod's ParameterManager scores each cycle in
    bytes a second and may move the fusion threshold, after which the
    cycles fuse differently). In the port a rebuild re-plans the live
    optimizer (:meth:`_DistributedOptimizerMixin.replan`): its state
    stays, so ``build`` re-plans and returns the step::

        opt = hvd.DistributedOptimizer(torch.optim.AdamW(...))

        def build(threshold):
            opt.replan(threshold)
            return step                      # closes over opt

        stepper = hvd.AutotunedStepper(build, grad_bytes=nbytes)
        while training:
            loss = stepper(batch)

    ``build`` is called with the threshold; with a tuner that tunes the
    hierarchical, overlap, compression or route axes with ``(threshold,
    hierarchical)``, ``(..., overlap)``, ``(..., compression)`` or
    ``(..., route)``; with any of the accumulation, remat, shard, MoE- or
    pipeline-wire axes with one :class:`~.common.autotune.TunedPoint`.
    ``grad_bytes`` is the bytes reduced a step (the score's numerator).
    ``tuner`` defaults to the context's (``init(autotune=True)`` /
    ``HVD_TPU_AUTOTUNE=1``). ``block=True`` times a step to the end of
    its device work: every CUDA device of the step's output tensors (or,
    with none, the context's GPU) is synchronized.

    In a world of more than one process only rank 0 records; at every
    period boundary (warmup + steps a sample calls) every rank exchanges
    the pipe-joined point through the controller (the JAX format, byte
    for byte), rank 0's value wins (the other ranks' tuners mirror it),
    and a ``:done`` suffix stops the rounds. Every rank therefore
    re-plans at the same call, which a ZeRO re-plan (collective)
    needs."""

    # The exchanged axes, their tuner switches and how each travels.
    _AXES = ("threshold", "hierarchical", "overlap", "compression", "route",
             "accum", "remat", "shard", "moe_wire", "pp_wire")
    _PARSE = (int, lambda v: bool(int(v)), lambda v: bool(int(v)), str,
              str, int, str, int, str, str)
    _MFU_AXES = ("accum", "remat", "shard", "moe_wire", "pp_wire")

    def __init__(self, build_step: Callable, grad_bytes: int, tuner=None,
                 block: bool = True, controller=None):
        from .common.autotune import TunedPoint

        if tuner is None:
            tuner = basics.context().autotuner \
                if basics.is_initialized() else None
            if tuner is None:
                raise ValueError(
                    "runtime autotuner not enabled — init(autotune=True) "
                    "or set HVD_TPU_AUTOTUNE=1, or pass tuner= explicitly")
        if controller is None and basics.is_initialized():
            controller = basics.context().controller
        self.tuner = tuner
        self.grad_bytes = int(grad_bytes)
        self.block = block
        self._build = build_step
        self._controller = controller
        self._period = tuner.warmup + tuner.steps_per_sample
        self._calls = 0
        self._tuner_done = False  # set when rank 0 sends :done
        #: Which axes the tuner tunes; an untuned one stays at its
        #: default (the threshold is always tuned).
        self._tuned = (True,) + tuple(
            bool(getattr(tuner, f"tune_{axis}", False))
            for axis in self._AXES[1:])
        self._pt = self._masked(tuner.current_full,
                                TunedPoint(tuner.current, False, False,
                                           "none", "flat", 1, "none", 0))
        self._step = self._rebuild()
        self.rebuilds = 0
        self._step_count = 0  # the profiler bridge's step numbering

    def _masked(self, pt, cur):
        """``pt`` on the tuned axes, ``cur`` on the others."""
        return type(cur)(*(v if on else c for v, on, c in
                           zip(pt[:len(self._AXES)], self._tuned, cur)),
                         *cur[len(self._AXES):])

    def _rebuild(self):
        on = dict(zip(self._AXES, self._tuned))
        if any(on[a] for a in self._MFU_AXES):
            return self._build(self._pt)
        # The positional cascade: as wide as the last tuned axis of
        # (hierarchical, overlap, compression, route).
        width = max((i + 1 for i, a in enumerate(self._AXES[:5]) if on[a]),
                    default=1)
        return self._build(*self._pt[:width])

    @property
    def fusion_threshold(self) -> int:
        return self._pt.threshold

    @property
    def hierarchical(self) -> bool:
        return self._pt.hierarchical

    @property
    def overlap(self) -> bool:
        return self._pt.overlap

    @property
    def compression(self) -> str:
        return self._pt.compression

    @property
    def route(self) -> str:
        return self._pt.route

    @property
    def accum(self) -> int:
        return self._pt.accum

    @property
    def remat(self) -> str:
        return self._pt.remat

    @property
    def shard(self) -> int:
        """The tuned ZeRO stage (0 = replicated)."""
        return self._pt.shard

    @property
    def moe_wire(self) -> str:
        return self._pt.moe_wire

    @property
    def pp_wire(self) -> str:
        return self._pt.pp_wire

    def _block(self, out) -> None:
        devices = {t.device for t in tree_lib.leaves(out)
                   if isinstance(t, torch.Tensor) and t.is_cuda}
        if not devices and basics.is_initialized() \
                and basics.context().device.type == "cuda":
            devices = {basics.context().device}
        for dev in devices:
            torch.cuda.synchronize(dev)

    def _exchanged(self, c):
        """One period boundary at n > 1: rank 0's point (suggested first
        when a sample is complete), adopted by every rank."""
        if c.rank == 0 and self.tuner.ready():
            self.tuner.suggest()
        # An untuned axis travels as its default, as this point holds it.
        cur = self._masked(self.tuner.current_full, self._pt)
        mine = "|".join(str(int(v)) if isinstance(v, bool) else str(v)
                        for v in cur[:len(self._AXES)])
        if c.rank == 0 and self.tuner.done:
            mine += ":done"
        v0 = c.exchange("autotune_threshold", mine)[0]
        if v0.endswith(":done"):
            self._tuner_done = True
            v0 = v0[:-5]
        pt = type(self._pt)(*(parse(v) for parse, v in
                              zip(self._PARSE, v0.split("|"))))
        if c.rank != 0:
            # This rank's tuner mirrors the adopted point (its gauges).
            self.tuner.adopt(pt, self._tuner_done)
        return self._masked(pt, self._pt)

    def __call__(self, *args, **kwargs):
        import time

        self._step_count += 1
        t0 = time.perf_counter()
        with metrics_lib.step_annotation(self._step_count):
            out = self._step(*args, **kwargs)
            if self.block:
                self._block(out)
        dt = time.perf_counter() - t0
        if _METRICS_ON:
            _M_STEP.observe(dt)
        c = self._controller
        if c is None or c.size == 1:
            new = self._masked(self.tuner.feed_full(self.grad_bytes, dt),
                               self._pt)
        else:
            if c.rank == 0:
                self.tuner.record(self.grad_bytes, dt)
            self._calls += 1
            new = self._pt
            if self._calls % self._period == 0 and not self._tuner_done:
                # A sample boundary, at the same call on every rank.
                new = self._exchanged(c)
        if new != self._pt:
            self._pt = new
            self._step = self._rebuild()
            self.rebuilds += 1
            _M_REBUILDS.inc()
        return out


def _resolve_route(route) -> Optional[C.WirePlan]:
    """``route`` (None: the configured default) as a plan, or None for
    the flat axis, which a plan naming an axis this world does not have
    also falls back to."""
    ctx = basics.context()
    plan = C.WirePlan.resolve(ctx.config.route if route is None else route)
    if plan is None or not all(a in ctx.axes for a in plan.axis_names):
        return None
    return plan


def observe_ef_residual(optimizer) -> Optional[float]:
    """Global L2 norm of an ``int8_ef`` optimizer's error-feedback
    residual (this rank's), published as the ``hvd_tpu_ef_residual_norm``
    gauge; None for an optimizer without error feedback."""
    if not getattr(optimizer, "_ef", False):
        return None
    total = sum(float(r.double().pow(2).sum())
                for r in list(optimizer._ef_residual.values())
                + list(getattr(optimizer, "_ef_parked", {}).values()))
    norm = math.sqrt(total)
    _M_EF_NORM.set(norm)
    return norm


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """In-place broadcast of a ``state_dict`` or an iterable of
    ``(name, tensor)`` pairs from ``root_rank``."""
    items = params.items() if hasattr(params, "items") else params
    with torch.no_grad():
        for _, p in items:
            if isinstance(p, torch.Tensor):
                C.broadcast_(p.data if p.requires_grad else p, root_rank)


class _TensorSlot:
    """Stands for one state tensor in the broadcast skeleton."""

    def __init__(self, t: torch.Tensor):
        self.shape = tuple(t.shape)
        self.dtype = t.dtype
        self.on_cpu = t.device.type == "cpu"


def _map_tensors(obj, fn):
    """``obj`` (nested dicts/lists/tuples) with every tensor or slot
    replaced by ``fn(leaf)``, visited in a fixed order."""
    if isinstance(obj, (torch.Tensor, _TensorSlot)):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Make every rank's optimizer state and hyperparameters
    ``root_rank``'s: the state dict's structure and scalars travel as
    one object, then each state tensor is broadcast, in the order both
    sides visit them. A rank whose state is still empty (no step yet)
    receives the root's. An ``int8_ef`` optimizer's error-feedback state
    is each rank's own and is not broadcast."""
    root = basics.rank() == root_rank
    tensors: List[torch.Tensor] = []

    def take(t: torch.Tensor) -> _TensorSlot:
        tensors.append(t)
        return _TensorSlot(t)

    def alloc(slot: _TensorSlot) -> torch.Tensor:
        tensors.append(torch.empty(
            slot.shape, dtype=slot.dtype,
            device="cpu" if slot.on_cpu else basics.device()))
        return tensors[-1]

    box = [None]
    if root:
        sd = optimizer.state_dict()
        sd.pop(_EF_STATE, None)
        box = [_map_tensors(sd, take)]
    overlap_lib.drain_before_collective()
    dist.broadcast_object_list(box, src=root_rank)
    state = None if root else _map_tensors(box[0], alloc)
    for t in tensors:
        C.broadcast_(t, root_rank)
    if state is not None:
        optimizer.load_state_dict(state)


# The ZeRO surfaces live in zero.py (which imports this module).
_ZERO_NAMES = ("ShardedOptimizer", "FSDPOptimizer", "ZeroOptimizer",
               "sharded_init", "sharded_update", "auto_shard_threshold",
               "should_shard_update")


def __getattr__(name):
    if name in _ZERO_NAMES:
        from . import zero

        return getattr(zero, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
