"""MXNet binding shim — the reference ``horovod.mxnet`` API surface over
the port's eager engine (the port's copy of
``horovod_tpu/mxnet/__init__.py``).

Reference: horovod/mxnet/__init__.py:39-149 (DistributedOptimizer wrapping
``mx.optimizer.Optimizer`` with per-gradient allreduce folded into
``rescale_grad``; gluon DistributedTrainer overriding ``_allreduce_grads``;
``broadcast_parameters`` incl. deferred-initialization injection) +
horovod/mxnet/mpi_ops.py:54-261 (allreduce(_)/allgather/broadcast(_)/
alltoall on NDArrays).

Role: host-side MXNet components (data pipelines, legacy gluon models,
evaluation) get the five collectives backed by the port's
engine/controller/fusion machinery so a migration can move one piece at
a time. Tensors cross at the numpy boundary via ``NDArray.asnumpy()`` /
``tensor[:] = ...``: the array becomes a torch tensor on this process's
``device()`` (the GPU unless ``init(device="cpu")``), so a scaled
allreduce runs the scale kernel K1 on the card, and this rank's result
comes back through numpy. One process is one rank: ``allgather``,
``broadcast`` and ``alltoall`` follow reference Horovod's per-rank
semantics. The shim is duck-typed against that protocol, so it is
importable (and testable) without mxnet installed — only
``DistributedTrainer`` requires the real ``mx.gluon.Trainer`` base
class.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np

import horovod_tpu_torch as _hvd
from ..common.basics import export_capability_queries as _ecq
from ..common.host_bridge import to_numpy as _from_torch
from ..common.host_bridge import to_torch as _to_torch

try:  # pragma: no cover - exercised only where mxnet is installed
    import mxnet as mx

    _HAS_MXNET = True
except ImportError:
    mx = None
    _HAS_MXNET = False

# re-exported basics (reference mxnet/__init__.py surface)
init = _hvd.init
shutdown = _hvd.shutdown
is_initialized = _hvd.is_initialized
rank = _hvd.rank
size = _hvd.size
local_rank = _hvd.local_rank
local_size = _hvd.local_size
Average, Sum, Adasum, Min, Max, Product = (
    _hvd.Average, _hvd.Sum, _hvd.Adasum, _hvd.Min, _hvd.Max, _hvd.Product)
# object helpers (reference mxnet/functions.py:27-92 broadcast_object /
# allgather_object — cloudpickle over the engine's byte collectives)
broadcast_object = _hvd.broadcast_object
allgather_object = _hvd.allgather_object
# capability queries (reference mxnet re-exports of basics.py:160-258)
_ecq(globals())


def _to_numpy(tensor) -> np.ndarray:
    """NDArray / numpy / buffer -> host numpy (the mpi_ops.cc
    tensor_util.cc boundary)."""
    if hasattr(tensor, "asnumpy"):
        return tensor.asnumpy()
    return np.asarray(tensor)


def _wrap(tensor, result: np.ndarray):
    """``result`` as an NDArray where the input was one (and mxnet is
    installed), else as a host array."""
    if hasattr(tensor, "asnumpy") and mx is not None:
        return mx.nd.array(result, dtype=result.dtype)
    return result


def _write_back(tensor, value: np.ndarray):
    """In-place write honoring the NDArray protocol (``t[:] = v``)."""
    if tensor.shape == ():
        raise ValueError("in-place collectives need a non-scalar tensor")
    tensor[:] = value
    return tensor


# -- collectives (reference mxnet/mpi_ops.py) -------------------------------

def allreduce(tensor, average: bool = True, name: Optional[str] = None,
              priority: int = 0, prescale_factor: float = 1.0,
              postscale_factor: float = 1.0):
    """Reference mpi_ops.py:54-101 — note the mxnet surface uses
    ``average: bool`` rather than a ReduceOp. ``priority`` orders the
    mxnet engine's async dispatch; the port issues collectives in call
    order, so it is accepted and ignored."""
    op = Average if average else Sum
    arr = _to_numpy(tensor)
    out = _hvd.allreduce(_to_torch(arr), op, name,
                         prescale_factor=prescale_factor,
                         postscale_factor=postscale_factor)
    return _wrap(tensor, _from_torch(out, arr.dtype))


def allreduce_(tensor, average: bool = True, name: Optional[str] = None,
               priority: int = 0, prescale_factor: float = 1.0,
               postscale_factor: float = 1.0):
    return _write_back(tensor, _to_numpy(
        allreduce(tensor, average, name, priority, prescale_factor,
                  postscale_factor)))


def allgather(tensor, name: Optional[str] = None, priority: int = 0):
    """Every rank's tensor (one shape on every rank) concatenated along
    dim 0 in rank order."""
    arr = _to_numpy(tensor)
    out = _hvd.allgather(_to_torch(arr), name)
    return _wrap(tensor, _from_torch(out, arr.dtype))


def broadcast(tensor, root_rank: int = 0, name: Optional[str] = None,
              priority: int = 0):
    arr = _to_numpy(tensor)
    out = _hvd.broadcast(_to_torch(arr), root_rank, name)
    return _wrap(tensor, _from_torch(out, arr.dtype))


def broadcast_(tensor, root_rank: int = 0, name: Optional[str] = None,
               priority: int = 0):
    return _write_back(tensor, _to_numpy(
        broadcast(tensor, root_rank, name, priority)))


def alltoall(tensor, splits=None, name: Optional[str] = None,
             priority: int = 0):
    """Dim 0 in n equal chunks, chunk ``j`` to rank ``j`` — or, with
    ``splits`` (this rank's send counts), ``splits[j]`` rows to rank
    ``j``; returns the rows received, in source-rank order."""
    arr = _to_numpy(tensor)
    out = _hvd.alltoall(_to_torch(arr), name,
                        splits=None if splits is None else list(splits))
    return _from_torch(out, arr.dtype)


# -- DistributedOptimizer (reference mxnet/__init__.py:39-84) ---------------

class DistributedOptimizer:
    """Wraps an mxnet optimizer: ``update``/``update_multi_precision``
    allreduce the gradient (SUM) before delegating, with the average
    folded into ``rescale_grad`` (the reference's trick: normalizing
    rescale_grad by size is equivalent to, and faster than, averaging in
    the collective — mxnet/__init__.py:44-48).

    Duck-typed delegation wrapper (the reference subclasses
    ``mx.optimizer.Optimizer`` purely for isinstance; all behavior is
    delegation there too)."""

    def __init__(self, optimizer, gradient_predivide_factor: float = 1.0):
        self._optimizer = optimizer
        self._optimizer.rescale_grad *= (
            gradient_predivide_factor / size())
        self._gradient_predivide_factor = gradient_predivide_factor

    def __getattr__(self, item):
        return getattr(self._optimizer, item)

    def create_state_multi_precision(self, index, weight):
        return self._optimizer.create_state_multi_precision(index, weight)

    def _do_allreduce(self, index, grad):
        if size() == 1:
            return
        pre = 1.0 / self._gradient_predivide_factor
        if isinstance(index, (tuple, list)):
            for i in range(len(index)):
                allreduce_(grad[i], average=False, name=str(index[i]),
                           priority=-i, prescale_factor=pre)
        else:
            allreduce_(grad, average=False, name=str(index),
                       prescale_factor=pre)

    def update(self, index, weight, grad, state):
        self._do_allreduce(index, grad)
        self._optimizer.update(index, weight, grad, state)

    def update_multi_precision(self, index, weight, grad, state):
        self._do_allreduce(index, grad)
        self._optimizer.update_multi_precision(index, weight, grad, state)

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def set_lr_mult(self, args_lr_mult):
        self._optimizer.set_lr_mult(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self._optimizer.set_wd_mult(args_wd_mult)


def allreduce_grads_inplace(params, prefix: str = "",
                            gradient_predivide_factor: float = 1.0
                            ) -> None:
    """SUM-allreduce every trainable parameter's gradient in place — the
    body of DistributedTrainer._allreduce_grads (reference
    mxnet/__init__.py:128-139), shared so the flow is testable without
    the gluon Trainer base class. ``params``: iterable of objects with
    ``grad_req`` and ``list_grad()``."""
    if size() == 1:
        return
    pre = 1.0 / gradient_predivide_factor
    for i, param in enumerate(params):
        if param.grad_req != "null":
            allreduce_(param.list_grad()[0], average=False,
                       name=prefix + str(i), priority=-i,
                       prescale_factor=pre)


if _HAS_MXNET:  # pragma: no cover - requires mxnet
    class DistributedTrainer(mx.gluon.Trainer):
        """Reference mxnet/__init__.py:92-139: gluon Trainer whose
        gradient reduction rides the engine's collectives instead of
        kvstore, with averaging folded into ``_scale``."""

        def __init__(self, params, optimizer, optimizer_params=None,
                     gradient_predivide_factor: float = 1.0,
                     prefix: Optional[str] = None):
            if isinstance(optimizer, DistributedOptimizer):
                optimizer = optimizer._optimizer
                warnings.warn("DistributedTrainer does not take "
                              "DistributedOptimizer as its optimizer. "
                              "We have unwrapped it for you.")
            super().__init__(params, optimizer,
                             optimizer_params=optimizer_params,
                             kvstore=None)
            self._scale *= gradient_predivide_factor / size()
            self._gradient_predivide_factor = gradient_predivide_factor
            assert prefix is None or isinstance(prefix, str)
            self._prefix = prefix if prefix else ""

        def _allreduce_grads(self):
            allreduce_grads_inplace(self._params, self._prefix,
                                    self._gradient_predivide_factor)
else:
    class DistributedTrainer:  # noqa: D401 - import-gated stub
        """Requires mxnet (gluon Trainer base class)."""

        def __init__(self, *a, **k):
            raise ImportError(
                "DistributedTrainer requires mxnet; the rest of the "
                "horovod_tpu_torch.mxnet surface (collectives, "
                "DistributedOptimizer, broadcast_parameters) is "
                "mxnet-optional")


# -- broadcast_parameters (reference mxnet/__init__.py:142-196) -------------

def _append_broadcast_init(param, root_rank, name):
    import types

    init_impl = getattr(param, "_init_impl")

    def wrapped_init_impl(self, *args, **kwargs):
        init_impl(*args, **kwargs)
        broadcast_(self.data(), root_rank=root_rank, name=name)

    return types.MethodType(wrapped_init_impl, param)


def broadcast_parameters(params, root_rank: int = 0,
                         prefix: Optional[str] = None) -> None:
    """Broadcast a dict / gluon ParameterDict of parameters from
    ``root_rank``; deferred-initialization parameters get the broadcast
    injected after their init (reference mxnet/__init__.py:142-196)."""
    if size() == 1:
        return
    assert prefix is None or isinstance(prefix, str)
    prefix = prefix if prefix else ""
    if not isinstance(params, dict) and not hasattr(params, "items"):
        raise ValueError(f"invalid params of type: {type(params)}")

    deferred_error = ()
    if _HAS_MXNET:  # pragma: no cover - requires mxnet
        deferred_error = (mx.gluon.parameter.DeferredInitializationError,)

    tensors, names = [], []
    for name, p in sorted(params.items()):
        try:
            if hasattr(p, "data") and callable(p.data):
                tensors.append(p.data())
            else:
                tensors.append(p)
            names.append(prefix + str(name))
        except deferred_error:  # pragma: no cover - requires mxnet
            p._init_impl = _append_broadcast_init(
                p, root_rank, prefix + str(name))

    for tensor, name in zip(tensors, names):
        broadcast_(tensor, root_rank, name=name)
