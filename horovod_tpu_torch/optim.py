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

The ``collective`` fault site (``common/faults.py``) is consulted once a
reduction round, at ``synchronize()``. After a failure the elastic
restore calls ``abort_step()``, which drops the step in progress (its
issued buckets, counters, guard round and worker); after an in-process
reset ``rebind()`` takes the new world's axis handles.
"""

from __future__ import annotations

import contextlib
import functools
import math
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


class StepTimer:
    """Host-side step-phase breakdown — the grad/comm/apply split of the
    ``hvd_tpu_step_phase_seconds`` histogram (the JAX package's
    ``StepTimer``). With the profiler bridge on
    (``HVD_TPU_METRICS_TRACE=1``) each phase is also a
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
    ``"comm"`` unless the caller already times one. Zero-cost when
    metrics are disabled (every call lands on the no-op singleton; the
    comm clock still runs)."""

    def __init__(self, name: str = "hvd_step"):
        self.name = name

    @contextlib.contextmanager
    def phase(self, phase: str):
        """Context manager timing one named phase."""
        timer = _M_PHASE.labels(phase=phase).time(
            annotation=f"{self.name}/{phase}"
            if metrics_lib.registry().trace_bridge else None)
        with contextlib.ExitStack() as stack:
            if phase == "comm":
                stack.enter_context(autoscale_lib.comm_clock.waiting())
            stack.enter_context(timer)
            yield

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
    ``"comm"`` phase, unless the caller already times one. While the
    autoscale publisher measures this rank's busy time, the rank's own
    device work is finished first: waiting for it is busy time, not a
    wait for peers."""
    if autoscale_lib.comm_clock.active():
        yield
        return
    if device.type == "cuda" and autoscale_lib.publishing():
        torch.cuda.synchronize(device)
    with StepTimer().phase("comm"):
        yield

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
                   overlap=False):
        self._base_cls = base_cls
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
        self._dist_plan = fusion_lib.plan_fusion(
            self._dist_params, threshold, order=fusion_lib.ORDER_REVERSE)
        #: Error feedback (``int8_ef``): per-bucket wires, the residual of
        #: every int8 bucket (one fp32 flat buffer, made at first use) and
        #: the step counter of the stochastic-rounding keys.
        self._ef = getattr(compression, "error_feedback", False)
        if self._ef:
            self._dist_plan = fusion_lib.assign_wire_dtypes(
                self._dist_plan, quantize_min_bytes)
        self._ef_residual: Dict[int, torch.Tensor] = {}
        self._ef_step = 0
        self._bucket_of = {}
        for bi, bucket in enumerate(self._dist_plan.buckets):
            for i in bucket.leaf_indices:
                self._bucket_of[id(self._dist_params[i])] = bi
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
        """Fuse, guard, compress, prescale and issue bucket ``bi``'s SUM;
        an int8_ef bucket is only fused (and guarded) here and reduced at
        :meth:`synchronize`."""
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
        or None)``. Reads the residual and step; commits nothing."""
        if kind == _DEFERRED_INT8:
            return self._reduce_int8(bi, wire)
        if kind == _DEFERRED_ROUTED:
            wire = self._reduce_routed(wire)
        elif kind == _ISSUED:
            C._allreduce_async_inplace(wire, self._sum_op(),
                                       self._axis).wait()
        else:
            kind.wait()         # the work handle issued in _launch
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
        if self.overlap:
            # Every chain, in plan order; a failed hop raises here.
            for bi in sorted(self._dist_inflight):
                done[bi] = self._dist_inflight[bi][0].wait()
        if self._guard is not None and self._agree() is False:
            # A globally agreed bad step: finish the bucket collectives
            # every rank issued, discard their results, reduce no int8
            # bucket (residual and rounding step unchanged) and leave
            # p.grad as backprop left it; step() skips the update.
            if not self.overlap:
                for work, _, _ in self._dist_inflight.values():
                    if not isinstance(work, str):
                        work.wait()
            self._dist_inflight.clear()
            self._reset_counts()
            self._dist_dirty = False
            self._guard_skip = True
            return
        self._guard_skip = False
        if not self.overlap:
            for bi in sorted(self._dist_inflight):
                done[bi] = self._chain(bi, *self._dist_inflight[bi])
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
        "residual": {bucket index: fp32 flat residual}}``; with a
        non-finite guard its counters and loss scale under
        ``"guard_state"``."""
        sd = self._base_cls.state_dict(self)
        if self._ef:
            sd[_EF_STATE] = {"step": self._ef_step,
                             "residual": dict(self._ef_residual)}
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
        buckets = self._dist_plan.buckets
        residual = {}
        for bi, r in ef["residual"].items():
            bi = int(bi)
            if not 0 <= bi < len(buckets) \
                    or r.numel() != buckets[bi].total_elems:
                raise ValueError(
                    f"load_state_dict: error-feedback residual of bucket "
                    f"{bi} ({r.numel()} elements) does not fit this "
                    f"optimizer's {len(buckets)} buckets")
            dev = self._dist_params[buckets[bi].leaf_indices[0]].device
            residual[bi] = r.to(device=dev, dtype=torch.float32).clone()
        self._ef_residual = residual
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
        optimizer's step, which a step the guard skipped does not run."""
        if self._should_synchronize:
            self.synchronize()
        if self._guard_skip:
            self._guard_skip = False
            return None
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
                   accum_k=1, remat_name="none", overlap=False):
        self._base_cls = base_cls
        self._adasum_wire = wire
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
                         overlap: bool = False):
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
    1, as the JAX package refuses them, and ``process_set``."""
    op = C.ReduceOp(op)
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
            overlap=overlap)
    if gradient_predivide_factor != 1.0 and op != C.Average:
        raise ValueError("gradient_predivide_factor requires op=Average")
    axis = None
    if process_set is not None:
        process_set.engine      # registered, and this rank a member
        axis = process_set.axis
    plan = _resolve_route(route)
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
                       overlap)
        return obj
    threshold = cfg.fusion_threshold_bytes if fusion_threshold_bytes is None \
        else int(fusion_threshold_bytes)
    qmin = cfg.quantize_min_bucket_bytes if quantize_min_bucket_bytes is None \
        else int(quantize_min_bucket_bytes)
    obj = _graft(optimizer, _DistributedOptimizerMixin)
    obj._dist_init(optimizer.__class__, named_parameters, op, k, compressor,
                   float(gradient_predivide_factor), threshold, qmin,
                   bool(sparse_as_dense), guard_policy, scale_cfg, accum_k,
                   remat_name, axis, plan, overlap)
    return obj


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
                for r in optimizer._ef_residual.values())
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
