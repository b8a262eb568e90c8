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
  and K9 (combine).

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request they raise.
Names of the JAX package's API that later slices bring raise
``NotImplementedError`` naming their slice.
"""

from .common.basics import (device, init, is_initialized, local_rank,
                            local_size, rank, shutdown, size)
from .common.device import resolve_device
from .common.exceptions import (HorovodInternalError, HorovodTpuError,
                                NotInitializedError,
                                TensorShapeMismatchError)
from .common.metrics import metrics
from .ops.adasum import adasum_allreduce
from .ops.collectives import (Adasum, Average, Max, Min, ReduceOp, Sum,
                              allgather, allreduce, allreduce_async_,
                              barrier, broadcast, broadcast_,
                              grouped_allreduce, quantized_allreduce)
from .ops.compression import Compression
from .optim import (DistributedOptimizer, broadcast_optimizer_state,
                    broadcast_parameters, observe_ef_residual)

__all__ = [
    "Adasum", "Average", "Compression", "DistributedOptimizer",
    "HorovodInternalError", "HorovodTpuError", "Max", "Min",
    "NotInitializedError", "ReduceOp", "Sum", "TensorShapeMismatchError",
    "adasum_allreduce", "allgather", "allreduce", "allreduce_async_",
    "barrier", "broadcast", "broadcast_", "broadcast_optimizer_state",
    "broadcast_parameters", "device", "grouped_allreduce", "init",
    "is_initialized", "local_rank", "local_size", "metrics",
    "observe_ef_residual", "quantized_allreduce", "rank", "resolve_device",
    "shutdown", "size",
]

# The JAX package's API that later slices of the port bring, by slice.
_LATER = {
    "the eager-engine slice (with kernel K1)": (
        "allreduce_async", "allgather_async", "broadcast_async", "poll",
        "synchronize", "join", "alltoall", "reducescatter", "allgatherv",
        "grouped_allgather", "grouped_reducescatter", "broadcast_object",
        "allgather_object", "start_timeline", "stop_timeline"),
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
