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

Not ported yet (they raise ``NotImplementedError`` naming their slice):
``op=Adasum``, ``nonfinite_policy``, ``route``, ``zero_stage``,
``accum_steps``, process sets, int8 compression.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from .common import basics
from .common import fusion as fusion_lib
from .ops import collectives as C
from .ops.compression import Compression, Compressor

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
                   predivide, threshold):
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

    def _launch(self, bi: int) -> None:
        """Fuse, compress, prescale and issue bucket ``bi``'s SUM."""
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
        wire, ctx = self._compression.compress(
            fusion_lib.fuse_bucket(grads, bucket))
        if self._predivide != 1.0:
            wire = C._apply_scale(wire, 1.0 / self._predivide)
        work = C.allreduce_async_(wire, C.Sum)
        self._dist_inflight[bi] = (work, wire, ctx)
        self.bucket_allreduces += 1

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
            work.wait()
            if self.op == C.Average:
                if self._predivide != 1.0:
                    wire = C._apply_scale(wire, self._predivide / n)
                else:
                    wire = C._divide_by_size(wire, n)
            flat = self._compression.decompress(wire, ctx)
            for i, view in fusion_lib.unfuse_bucket(
                    flat, self._dist_plan.buckets[bi]):
                self._dist_params[i].grad.copy_(view)
        self._dist_inflight.clear()
        self._reset_counts()
        self._dist_dirty = False

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


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression=None,
                         backward_passes_per_step: int = 1,
                         op: C.ReduceOp = C.Average,
                         gradient_predivide_factor: float = 1.0,
                         fusion_threshold_bytes: Optional[int] = None,
                         process_set=None,
                         **unported):
    """Wrap ``optimizer`` so ``step()`` first averages (``op=Average``) or
    sums (``op=Sum``) the gradients across ranks, in fused buckets.

    ``compression`` is None (``HVD_TPU_COMPRESSION``, default none),
    ``"none"``/``"fp16"``/``"bf16"`` or a Compressor class.
    ``backward_passes_per_step=k`` accumulates k local backward passes
    (summed in ``p.grad``, as PyTorch accumulates) before the reduction.
    ``gradient_predivide_factor`` f splits the average around the sum
    (1/f before, f/n after) and requires ``op=Average``.
    ``fusion_threshold_bytes`` defaults to the ``init()`` setting
    (``HVD_TPU_FUSION_THRESHOLD``, 64 MiB)."""
    for key in unported:
        if key not in _UNPORTED:
            raise TypeError(f"DistributedOptimizer() got an unexpected "
                            f"keyword argument {key!r}")
        raise NotImplementedError(f"DistributedOptimizer({key}=...) is not "
                                  f"ported yet; it comes with "
                                  f"{_UNPORTED[key]} of the port")
    op = C.ReduceOp(op)
    if op == C.Adasum:
        raise NotImplementedError("op=Adasum is not ported yet; it comes "
                                  "with the Adasum slice of the port "
                                  "(kernels K8/K9)")
    if op not in (C.Average, C.Sum):
        raise ValueError(f"DistributedOptimizer reduces gradients with "
                         f"Average or Sum, got {op.name}")
    if gradient_predivide_factor != 1.0 and op != C.Average:
        raise ValueError("gradient_predivide_factor requires op=Average")
    if process_set is not None:
        raise NotImplementedError("process sets are not ported yet")
    k = int(backward_passes_per_step)
    if k < 1:
        raise ValueError(f"backward_passes_per_step must be >= 1, got {k}")
    cfg = basics.context().config
    threshold = cfg.fusion_threshold_bytes if fusion_threshold_bytes is None \
        else int(fusion_threshold_bytes)
    compressor = _resolve_compression(compression)
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               {k_: v for k_, v in _DistributedOptimizerMixin.__dict__.items()
                if not k_.startswith("__")})
    obj = cls.__new__(cls)
    obj.__dict__.update(optimizer.__dict__)  # share param_groups + state
    obj._dist_init(optimizer.__class__, named_parameters, op, k, compressor,
                   float(gradient_predivide_factor), threshold)
    return obj


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
    receives the root's."""
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

    box = [_map_tensors(optimizer.state_dict(), take) if root else None]
    dist.broadcast_object_list(box, src=root_rank)
    state = None if root else _map_tensors(box[0], alloc)
    for t in tensors:
        C.broadcast_(t, root_rank)
    if state is not None:
        optimizer.load_state_dict(state)
