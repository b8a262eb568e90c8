"""Standalone Keras binding — the reference ``horovod.keras`` namespace
(reference keras/__init__.py:36-177) over the port's eager engine (the
port's copy of ``horovod_tpu/keras/__init__.py``).

Everything rides the TensorFlow shim (``horovod_tpu_torch.tensorflow``),
the host-boundary migration surface; GPU training belongs on the port's
PyTorch surface (``hvd.DistributedOptimizer``). This module exists so
``import horovod.keras as hvd`` scripts port with only the package name
changing.
"""

from __future__ import annotations

from typing import Optional

import horovod_tpu_torch as _hvd
import horovod_tpu_torch.tensorflow as _tf_shim
from horovod_tpu_torch.ops.collectives import ReduceOp

from . import callbacks, elastic  # noqa: F401  (public submodules)

# -- basics (reference keras/__init__.py re-exports) ------------------------
init = _hvd.init
shutdown = _hvd.shutdown
is_initialized = _hvd.is_initialized
rank = _hvd.rank
size = _hvd.size
local_rank = _hvd.local_rank
local_size = _hvd.local_size
cross_rank = _hvd.cross_rank
cross_size = _hvd.cross_size
Average, Sum, Adasum, Min, Max, Product = (
    _hvd.Average, _hvd.Sum, _hvd.Adasum, _hvd.Min, _hvd.Max, _hvd.Product)
Compression = _hvd.Compression

allgather = _tf_shim.allgather
broadcast = _tf_shim.broadcast
broadcast_variables = _tf_shim.broadcast_variables
join = _tf_shim.join
# capability queries (reference keras re-exports of basics.py:160-258)
from horovod_tpu_torch.common.basics import (  # noqa: E402
    CAPABILITY_QUERY_NAMES as _CQN,
    export_capability_queries as _ecq,
)

_ecq(globals())


def allreduce(value, name: Optional[str] = None, average: bool = True,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0):
    """Keras-surface allreduce (reference keras/__init__.py:98-113 —
    ``average`` flag instead of a ReduceOp)."""
    op: ReduceOp = Average if average else Sum
    return _tf_shim.allreduce(value, op=op, name=name,
                              prescale_factor=prescale_factor,
                              postscale_factor=postscale_factor)


def DistributedOptimizer(optimizer, name: Optional[str] = None,
                         device_dense: str = "", device_sparse: str = "",
                         compression=None, sparse_as_dense: bool = False,
                         gradient_predivide_factor: float = 1.0,
                         op: ReduceOp = Average,
                         backward_passes_per_step: int = 1,
                         average_aggregated_gradients: bool = False):
    """Reference keras/__init__.py:36-86 signature (op restricted to
    Average/Sum there too; predivide splits averaging around the sum).
    ``device_dense`` / ``device_sparse`` / ``compression`` are accepted
    for drop-in compatibility but ignored: the collectives run on the
    port's ``device()``, and the host-boundary shim does not compress
    (compressed collectives live on the PyTorch surface). The
    aggregation kwargs are this framework's extension with the reference
    TF-surface defaults."""
    del name, device_dense, device_sparse, compression
    if op not in (Average, Sum):
        raise ValueError("op currently only supports Average and Sum "
                         "(reference keras/__init__.py:73)")
    return _tf_shim.DistributedOptimizer(
        optimizer, op=op,
        backward_passes_per_step=backward_passes_per_step,
        average_aggregated_gradients=average_aggregated_gradients,
        sparse_as_dense=sparse_as_dense,
        gradient_predivide_factor=gradient_predivide_factor)


def broadcast_global_variables(root_rank: int = 0, model=None) -> None:
    """Reference keras/__init__.py:88-97. TF1 collected "global
    variables" from the graph; Keras 3 has no global collection, so pass
    the ``model`` (its variables + optimizer variables are broadcast) or
    use ``callbacks.BroadcastGlobalVariablesCallback`` inside ``fit``."""
    if model is None:
        raise ValueError(
            "Keras 3 has no global-variable collection; pass model= or "
            "use hvd.callbacks.BroadcastGlobalVariablesCallback")
    variables = list(model.variables)
    if getattr(model, "optimizer", None) is not None:
        variables += list(model.optimizer.variables)
    broadcast_variables(variables, root_rank)


def _wrap_optimizer_class(cls):
    """Deserialization shim: Keras resolves the saved class name through
    custom_objects and calls ``from_config`` — return the distributed
    wrap of the freshly built inner optimizer."""

    class _Wrapped:
        @staticmethod
        def from_config(config, custom_objects=None):  # noqa: ARG004
            del custom_objects
            return DistributedOptimizer(cls.from_config(config))

    _Wrapped.__name__ = f"Distributed{cls.__name__}"
    return _Wrapped


def load_model(filepath, custom_optimizers=None, custom_objects=None,
               compression=None):
    """Load a saved Keras model whose optimizer was (or should become) a
    DistributedOptimizer (reference keras/__init__.py:143-177): every
    optimizer class in ``keras.optimizers`` — plus any
    ``custom_optimizers`` — is registered under both its own name and
    its ``Distributed*`` alias, so models saved before OR after wrapping
    reload with the wrap applied and optimizer state intact."""
    del compression  # signature parity; see DistributedOptimizer note
    import keras

    mapping = dict(custom_objects or {})
    seen = {}
    for attr in dir(keras.optimizers):
        cls = getattr(keras.optimizers, attr)
        if (isinstance(cls, type)
                and issubclass(cls, keras.optimizers.Optimizer)
                and cls is not keras.optimizers.Optimizer):
            seen[cls.__name__] = cls
    for cls in custom_optimizers or ():
        seen[cls.__name__] = cls
        # Custom classes aren't in keras' registry, so deserialization
        # DOES consult custom_objects for the plain name — register the
        # wrap there so an unwrapped-save reloads wrapped.
        mapping.setdefault(cls.__name__, _wrap_optimizer_class(cls))
    for cls_name, cls in seen.items():
        # Covers models saved AFTER wrapping: "DistributedAdam" is not a
        # keras-module name, so deserialization consults custom_objects.
        mapping.setdefault(f"Distributed{cls_name}",
                           _wrap_optimizer_class(cls))
    model = keras.models.load_model(filepath, custom_objects=mapping)

    # Models saved BEFORE wrapping deserialize through keras' own module
    # registry (custom_objects is not consulted for built-in names), so
    # wrap post-load: swap in the distributed subclass IN PLACE, keeping
    # the restored slot variables (from_config would zero them).
    opt = getattr(model, "optimizer", None)
    if opt is not None and not type(opt).__name__.startswith("Distributed"):
        donor = DistributedOptimizer(type(opt).from_config(opt.get_config()))
        opt.__class__ = type(donor)
    return model


__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "Average", "Sum", "Adasum",
    "Min", "Max", "Product", "Compression", "allreduce", "allgather",
    "broadcast", "broadcast_variables", "broadcast_global_variables",
    "DistributedOptimizer", "load_model", "callbacks", "elastic", "join",
    *_CQN,
]
