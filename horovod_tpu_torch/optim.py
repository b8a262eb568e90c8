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
overlapped with backprop as the other buckets are. The residual is one
fp32 flat buffer per int8 bucket, and the step counter advances once per
reduction round, i.e. once per ``step()``. Both are this rank's state,
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
``bf16`` they ride the bf16 wire.

Not ported yet (they raise ``NotImplementedError`` naming their slice):
``nonfinite_policy``, ``route``, ``zero_stage``, ``accum_steps``,
process sets.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from .common import basics
from .common import fusion as fusion_lib
from .common import metrics as metrics_lib
from .ops import adasum as adasum_lib
from .ops import collectives as C
from .ops.compression import (BF16Compressor, Compression, Compressor,
                              NoneCompressor, _check_reduce_safe)

_M_EF_NORM = metrics_lib.gauge(
    "hvd_tpu_ef_residual_norm",
    "global L2 norm of the error-feedback quantization residual "
    "(observe_ef_residual)")

# Base seed of the stochastic rounding: bucket i at step t rounds with the
# key (_EF_SEED, t, i), the same on every rank and on every rerun.
_EF_SEED = 0x5EED
# The state_dict key of this rank's error-feedback state.
_EF_STATE = "ef_state"


def _ef_key(step: int, bucket_index: int):
    """The stochastic-rounding key of one bucket at one step."""
    return (_EF_SEED, int(step), int(bucket_index))

_UNPORTED = {
    "nonfinite_policy": "the integrity-guard slice",
    "route": "the mesh-routing slice",
    "zero_stage": "the ZeRO/FSDP slice",
    "accum_steps": "the accumulation-with-remat slice",
}


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
                   predivide, threshold, quantize_min_bytes):
        self._base_cls = base_cls
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
        self._reset_counts()
        self._dist_hooks = [
            p.register_post_accumulate_grad_hook(self._hook)
            for p in self._dist_params]

    def _reset_counts(self) -> None:
        self._dist_delay = {id(p): self.backward_passes_per_step
                            for p in self._dist_params}
        self._dist_pending = [len(b.leaf_indices)
                              for b in self._dist_plan.buckets]

    def _hook(self, p: torch.Tensor) -> None:
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
        return BF16Compressor if wire == fusion_lib.WIRE_BF16 \
            else NoneCompressor

    def _launch(self, bi: int) -> None:
        """Fuse, compress, prescale and issue bucket ``bi``'s SUM; an
        int8_ef bucket is only fused here and reduced at
        :meth:`synchronize`."""
        bucket = self._dist_plan.buckets[bi]
        grads = {}
        for i in bucket.leaf_indices:
            p = self._dist_params[i]
            if p.grad is None:
                # A parameter backprop did not reach contributes zeros.
                p.grad = torch.zeros_like(p)
            if p.grad.is_sparse:
                raise ValueError("DistributedOptimizer got a sparse "
                                 "gradient; sparse gradients are not "
                                 "ported yet")
            grads[i] = p.grad
        flat = fusion_lib.fuse_bucket(grads, bucket)
        self.bucket_allreduces += 1
        if self._ef and \
                self._dist_plan.wire_dtypes[bi] == fusion_lib.WIRE_INT8:
            self._dist_inflight[bi] = (None, flat, None)
            return
        wire, ctx = self._wire_compressor(bi).compress(flat)
        if self._predivide != 1.0:
            wire = C._apply_scale(wire, 1.0 / self._predivide)
        work = C._allreduce_async_inplace(wire, C.Sum)
        self._dist_inflight[bi] = (work, wire, ctx)

    def _reduce_int8(self, bi: int, flat: torch.Tensor) -> torch.Tensor:
        """The error-feedback quantized reduction of bucket ``bi``: reduce
        ``g + residual`` through ``quantized_allreduce`` and keep its local
        error as the next residual (in unscaled gradient units)."""
        res = self._ef_residual.get(bi)
        corrected = flat.to(torch.float32)
        if res is not None:
            corrected = corrected + res
        op, post = self.op, 1.0
        if self._predivide != 1.0:
            corrected = corrected * (1.0 / self._predivide)
            op, post = C.Sum, self._predivide / basics.size()
        y, res = C.quantized_allreduce(corrected, op,
                                       key=_ef_key(self._ef_step, bi),
                                       return_residual=True)
        if self._predivide != 1.0:
            res = res * self._predivide
        self._ef_residual[bi] = res
        return C._apply_scale(y, post).to(flat.dtype)

    def synchronize(self) -> None:
        """Reduce every bucket not yet issued (a parameter mid-aggregation
        or without a gradient included), wait for all of them and write
        the reduced gradients into ``p.grad``."""
        if not self._dist_dirty and not self._dist_inflight:
            return
        for bi in range(len(self._dist_plan.buckets)):
            if bi not in self._dist_inflight:
                self._launch(bi)
        n = basics.size()
        for bi in sorted(self._dist_inflight):
            work, wire, ctx = self._dist_inflight[bi]
            if work is None:
                flat = self._reduce_int8(bi, wire)
            else:
                work.wait()
                if self.op == C.Average:
                    if self._predivide != 1.0:
                        wire = C._apply_scale(wire, self._predivide / n)
                    else:
                        wire = C._divide_by_size(wire, n)
                flat = self._wire_compressor(bi).decompress(wire, ctx)
            for i, view in fusion_lib.unfuse_bucket(
                    flat, self._dist_plan.buckets[bi]):
                self._dist_params[i].grad.copy_(view)
        self._dist_inflight.clear()
        self._reset_counts()
        self._dist_dirty = False
        if self._ef:
            self._ef_step += 1

    def state_dict(self):
        """The base optimizer's state dict and, under ``int8_ef``, this
        rank's error-feedback state: ``"ef_state": {"step": int,
        "residual": {bucket index: fp32 flat residual}}``."""
        sd = self._base_cls.state_dict(self)
        if self._ef:
            sd[_EF_STATE] = {"step": self._ef_step,
                             "residual": dict(self._ef_residual)}
        return sd

    def load_state_dict(self, state_dict) -> None:
        """The base optimizer's ``load_state_dict`` and, where the dict
        carries one, this rank's error-feedback state (residuals copied
        onto their buckets' device)."""
        sd = dict(state_dict)
        ef = sd.pop(_EF_STATE, None)
        self._base_cls.load_state_dict(self, sd)
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
        if self._should_synchronize:
            self.synchronize()
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
    (the JAX package's torch surface, ``_DistributedAdasumMixin``)."""

    def _dist_init(self, base_cls, named_parameters, wire):
        self._base_cls = base_cls
        self._adasum_wire = wire
        self._dist_names = {}
        if named_parameters is not None:
            self._dist_names = {id(p): n for n, p in named_parameters}
        #: Per-tensor Adasum reductions run so far.
        self.adasum_reductions = 0

    def step(self, closure=None):
        """The base optimizer's step on the local gradients, then every
        parameter's delta replaced by the Adasum of all ranks' deltas."""
        params = [p for group in self.param_groups for p in group["params"]]
        with torch.no_grad():
            before = [p.detach().clone() for p in params]
        result = self._base_cls.step(self, closure)
        with torch.no_grad():
            for p, b in zip(params, before):
                reduced = adasum_lib.adasum_allreduce(
                    p.detach() - b, wire=self._adasum_wire)
                p.copy_(b + reduced)
                self.adasum_reductions += 1
        return result


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
                         **unported):
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
    (``HVD_TPU_QUANTIZE_MIN_BYTES``, 64 KiB)."""
    for key in unported:
        if key not in _UNPORTED:
            raise TypeError(f"DistributedOptimizer() got an unexpected "
                            f"keyword argument {key!r}")
        raise NotImplementedError(f"DistributedOptimizer({key}=...) is not "
                                  f"ported yet; it comes with "
                                  f"{_UNPORTED[key]} of the port")
    op = C.ReduceOp(op)
    if op not in (C.Average, C.Sum, C.Adasum):
        raise ValueError(f"DistributedOptimizer reduces gradients with "
                         f"Average, Sum or Adasum, got {op.name}")
    if gradient_predivide_factor != 1.0 and op != C.Average:
        raise ValueError("gradient_predivide_factor requires op=Average")
    if process_set is not None:
        raise NotImplementedError("process sets are not ported yet")
    k = int(backward_passes_per_step)
    if k < 1:
        raise ValueError(f"backward_passes_per_step must be >= 1, got {k}")
    cfg = basics.context().config
    compressor = _resolve_compression(compression)
    _check_reduce_safe(compressor)
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
        obj._dist_init(optimizer.__class__, named_parameters, wire)
        return obj
    threshold = cfg.fusion_threshold_bytes if fusion_threshold_bytes is None \
        else int(fusion_threshold_bytes)
    qmin = cfg.quantize_min_bucket_bytes if quantize_min_bucket_bytes is None \
        else int(quantize_min_bucket_bytes)
    obj = _graft(optimizer, _DistributedOptimizerMixin)
    obj._dist_init(optimizer.__class__, named_parameters, op, k, compressor,
                   float(gradient_predivide_factor), threshold, qmin)
    return obj


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
    dist.broadcast_object_list(box, src=root_rank)
    state = None if root else _map_tensors(box[0], alloc)
    for t in tensors:
        C.broadcast_(t, root_rank)
    if state is not None:
        optimizer.load_state_dict(state)
