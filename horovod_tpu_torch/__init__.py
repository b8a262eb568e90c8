"""``horovod_tpu_torch`` — the PyTorch/CUDA port of ``horovod_tpu``.

The JAX package ``horovod_tpu`` is the frozen reference; this package
sits beside it and imports neither JAX nor anything of it. Plain tensor
code is PyTorch, and every TPU (Pallas) kernel on a ported path is a
kernel written by hand for NVIDIA Hopper under ``csrc/``, built with
``nvcc`` at first use.

Ported so far:

* slice 1 — disaggregated GPT serving: ``serve`` (engine, batcher,
  controller with prefill/decode roles, tracing, overload control),
  ``models.gpt``'s KV-cache path, and the int8 KV-wire codec kernels
  ``ops.kernels.quantize_int8``/``dequantize_int8`` (K2/K4);
* slice 2 — data-parallel GPT training: ``init``/``shutdown`` and the
  rank queries over ``torch.distributed``, the collectives, tensor
  fusion, cast compression, ``DistributedOptimizer`` with fused-bucket
  gradient reduction, ``models.gpt``'s full-sequence forward and
  ``next_token_loss``, and flash attention (``ops.flash_attention``) on
  the kernels K5 (forward), K6 (dq) and K7 (dk, dv);
* slice 3 — gradient reduction across ranks: ``init(backend="gloo")``
  for ranks sharing a GPU, ``Compression.int8``/``int8_ef`` with the
  error-feedback ``quantized_allreduce`` on the stochastic quantizer K3,
  and ``Adasum`` (``allreduce(op=Adasum)``, ``adasum_allreduce``,
  ``DistributedOptimizer(op=Adasum)``) on the kernels K8 (dot and norms)
  and K9 (combine);
* slice 4 — the eager collective engine (``ops/eager.py``) behind
  Horovod's own API: named ``allreduce`` (SUM, AVERAGE, MIN, MAX,
  PRODUCT, ADASUM; pre/postscale through the scale kernel K1; none,
  fp16, bf16 and int8_ef compression), ``grouped_allreduce`` (fused),
  ``allgather``/``allgatherv``, ``broadcast``, ``alltoall`` (wires none,
  bf16, int8 on K2/K4; uneven splits), ``reducescatter``, ``barrier``,
  ``join``, the async handles (``*_async``, ``allreduce_async_``, which
  writes in place at ``synchronize``, ``poll``, ``synchronize``),
  ``broadcast_object``/``allgather_object``, and the timeline; collectives
  are negotiated across ranks by the controller (``common/controller.py``)
  over the c10d store, once per signature.

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request they raise.
Names of the JAX package's API that later slices bring raise
``NotImplementedError`` naming their slice.
"""

from .common.basics import (device, init, is_initialized, local_rank,
                            local_size, rank, shutdown, size)
from .common.device import resolve_device
from .common.exceptions import (AlltoallvLayoutError,
                                DuplicateTensorNameError,
                                HorovodInternalError, HorovodTpuError,
                                MismatchError, NotInitializedError,
                                TensorShapeMismatchError)
from .common.metrics import metrics
from .functions import allgather_object, broadcast_object
from .ops.adasum import adasum_allreduce
from .ops.collectives import (Adasum, Average, Max, Min, Product, ReduceOp,
                              Sum, broadcast_, quantized_allreduce)
from .ops.compression import Compression
from .ops import eager as _eager
from .optim import (DistributedOptimizer, broadcast_optimizer_state,
                    broadcast_parameters, observe_ef_residual)

__all__ = [
    "Adasum", "AlltoallvLayoutError", "Average", "Compression",
    "DistributedOptimizer", "DuplicateTensorNameError",
    "HorovodInternalError", "HorovodTpuError", "Max", "Min",
    "MismatchError", "NotInitializedError", "Product", "ReduceOp", "Sum",
    "TensorShapeMismatchError", "adasum_allreduce", "allgather",
    "allgather_async", "allgather_object", "allgatherv", "allreduce",
    "allreduce_async", "allreduce_async_", "alltoall", "barrier",
    "broadcast", "broadcast_", "broadcast_async", "broadcast_object",
    "broadcast_optimizer_state", "broadcast_parameters", "device",
    "grouped_allgather", "grouped_allreduce", "grouped_reducescatter",
    "init", "is_initialized", "join", "local_rank", "local_size",
    "metrics", "observe_ef_residual", "poll", "quantized_allreduce", "rank",
    "reducescatter", "resolve_device", "shutdown", "size",
    "start_timeline", "stop_timeline", "synchronize",
]


# -- the eager API (the JAX package's signatures, one rank per process) ----

def _engine(process_set=None):
    if process_set is not None:
        raise NotImplementedError(
            "process_set= is not ported yet; it comes with the "
            "process-set slice of the port")
    from .common import basics as _basics

    return _basics.context().engine


def allreduce(x, op: ReduceOp = Average, name=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              compression=None, process_set=None):
    """The reduction of every rank's ``x`` (a new tensor on every rank).
    ``x * prescale_factor`` is reduced and the result multiplied by
    ``postscale_factor`` (kernel K1 on the card; the scale rounded to x's
    dtype, as the JAX package rounds it). ``compression=None`` takes the
    ``init(compression=)``/``HVD_TPU_COMPRESSION`` default; ``int8_ef``
    runs the quantized allreduce (round to nearest). Arguments after
    ``op`` are best passed by keyword (``name`` comes third, as in the
    JAX package)."""
    return _engine(process_set).allreduce(
        x, op, name, prescale_factor, postscale_factor, compression).wait()


def allreduce_async(x, op: ReduceOp = Average, name=None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0, compression=None) -> int:
    """:func:`allreduce`, issued: returns a handle for :func:`poll` and
    :func:`synchronize` (which returns the result)."""
    e = _engine()
    return e.async_call(e.allreduce, x, op, name, prescale_factor,
                        postscale_factor, compression)


def allreduce_async_(tensor, op: ReduceOp = Average, name=None,
                     process_set=None) -> int:
    """In-place :func:`allreduce_async` (Horovod's ``torch/mpi_ops.py``
    ``allreduce_async_``): returns a handle whose :func:`synchronize`
    writes the reduction of every rank's ``tensor`` into ``tensor`` and
    returns ``tensor``."""
    e = _engine(process_set)
    return e.async_call(_eager.InPlace, e.allreduce(tensor, op, name),
                        tensor)


def grouped_allreduce(tensors, op: ReduceOp = Average, name=None,
                      compression=None, prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0, process_set=None):
    """Allreduce a list of tensors through fusion buckets; returns the
    list of results."""
    return _engine(process_set).allreduce_tree(
        tensors, op, name, compression, prescale_factor,
        postscale_factor).wait()


def allgather(x, name=None, process_set=None):
    """Every rank's ``x`` (one shape on every rank) concatenated along
    dim 0."""
    return _engine(process_set).allgather(x, name).wait()


def allgatherv(x, name=None, process_set=None):
    """Every rank's rows concatenated along dim 0, where ranks may hold
    different row counts."""
    return _engine(process_set).allgatherv(x, name).wait()


def allgather_async(x, name=None) -> int:
    e = _engine()
    return e.async_call(e.allgather, x, name)


def grouped_allgather(tensors, name=None, process_set=None):
    """:func:`allgather` of each tensor of a list (issued together)."""
    e = _engine(process_set)
    pend = [e.allgather(v, f"{name}.{i}" if name else None)
            for i, v in enumerate(tensors)]
    return [p.wait() for p in pend]


def broadcast(x, root_rank: int = 0, name=None, process_set=None):
    """``root_rank``'s ``x`` as a new tensor on every rank."""
    return _engine(process_set).broadcast(x, root_rank, name).wait()


def broadcast_async(x, root_rank: int = 0, name=None) -> int:
    e = _engine()
    return e.async_call(e.broadcast, x, root_rank, name)


def alltoall(x, name=None, splits=None, process_set=None, chunked=None,
             wire=None):
    """Even all-to-all (dim 0 in ``size`` equal chunks, chunk ``j`` to
    rank ``j``), or with ``splits`` — this rank's send counts — the
    uneven one, whose receive counts are negotiated. ``wire`` ("bf16",
    "int8", "auto" or a ``Compression`` class) compresses the even
    exchange's payload."""
    return _engine(process_set).alltoall(x, name, splits=splits,
                                         chunked=chunked, wire=wire).wait()


def reducescatter(x, op: ReduceOp = None, name=None, process_set=None):
    """This rank's 1/size slice (dim 0) of the SUM or AVERAGE (the
    default, as on every surface of the JAX package) over ranks."""
    return _engine(process_set).reducescatter(
        x, Average if op is None else op, name).wait()


def grouped_reducescatter(tensors, op: ReduceOp = None, name=None,
                          process_set=None):
    """:func:`reducescatter` of each tensor of a list (issued
    together)."""
    e = _engine(process_set)
    pend = [e.reducescatter(v, Average if op is None else op,
                            f"{name}.{i}" if name else None)
            for i, v in enumerate(tensors)]
    return [p.wait() for p in pend]


def barrier(process_set=None) -> None:
    """Block until every rank has reached this call."""
    _engine(process_set).barrier()


def join() -> int:
    """Mark this process done; until every process has joined, take part
    in the others' allreduces with zero tensors (AVERAGE divides by the
    active ranks). Returns the last rank to join. Multi-process worlds
    must ``init(join_mode=True)`` (``HVD_TPU_JOIN_MODE=1``), so that
    every collective runs a coordination round."""
    return _engine().join()


def poll(handle: int) -> bool:
    """True when the collective behind ``handle`` has completed."""
    return _engine().poll(handle)


def synchronize(handle: int):
    """Wait for ``handle``'s collective and return its result."""
    return _engine().synchronize(handle)


def start_timeline(filename: str, mark_cycles: bool = False) -> None:
    """Write a Chrome trace of the eager collectives to ``filename``: a
    begin event at each submit and an end event at its synchronize."""
    from .common import basics as _basics

    _basics.context().timeline.start(filename, mark_cycles)


def stop_timeline() -> None:
    from .common import basics as _basics

    _basics.context().timeline.stop()


# The JAX package's API that later slices of the port bring, by slice.
_LATER = {
    "the process-set slice": (
        "ProcessSet", "add_process_set", "remove_process_set", "cross_rank",
        "cross_size", "is_homogeneous"),
    "the integrity-guard slice": (
        "integrity", "observe_guard", "current_loss_scale",
        "DivergenceDetector", "NonFiniteError", "DivergenceError"),
    "the accumulation-with-remat slice": (
        "accumulate_gradients", "resolve_remat_policy", "DeviceInfeed",
        "prefetch_to_device", "BackgroundPrefetcher", "infeed_pipeline",
        "shard_batch"),
    "the ZeRO/FSDP slice": (
        "ShardedOptimizer", "FSDPOptimizer", "ZeroOptimizer",
        "sharded_init", "sharded_update", "auto_shard_threshold",
        "should_shard_update"),
    "the elastic and launcher slice": (
        "run", "recovery_stats", "HostsUpdatedInterrupt",
        "CheckpointCorruptError", "flight_recorder"),
    "the parallel-roles slice": (
        "ParallelSpec", "parallel_spec", "parallel_mesh",
        "pipeline_accumulate_gradients", "pipeline_apply",
        "pipeline_train_step_1f1b", "tp_mlp", "tp_attention_qkv"),
}
_LATER_BY_NAME = {n: where for where, names in _LATER.items()
                  for n in names}


def __getattr__(name):
    where = _LATER_BY_NAME.get(name)
    if where is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    raise NotImplementedError(f"horovod_tpu_torch.{name} is not ported "
                              f"yet; it comes with {where} of the port")
