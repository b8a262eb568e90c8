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
  over the c10d store, once per signature;
* slice 8 — the rest of Horovod's PyTorch surface and the model zoo;
* slice 9 — what a long job needs to run safely: the integrity guard
  (``DistributedOptimizer(nonfinite_policy=)`` with K1 unscaling under
  ``scale_backoff``, ``observe_guard``, ``current_loss_scale``,
  ``DivergenceDetector``; ``common/integrity.py``), accumulation with
  remat (``DistributedOptimizer(accum_steps=, remat_policy=)``,
  ``optimizer.accumulate``, ``accumulate_gradients``), the CUDA infeed
  (``data.py``: ``DeviceInfeed`` on a copy stream, ``shard_batch``,
  ``ElasticSampler``), verified checkpoints (``checkpoint.py``:
  ``CheckpointManager`` with CRC sidecars and walk-back) and the training
  callbacks (``callbacks.py``);
* slice 10 — process sets and the topology: ``init(comm=,
  process_sets=, mesh_shape=)``, ``cross_rank``/``cross_size``/
  ``is_homogeneous``, ``ProcessSet`` with ``add_process_set``/
  ``remove_process_set`` and ``process_set=`` on every eager call and on
  ``DistributedOptimizer``; the mesh router (``WirePlan``,
  ``ops.collectives.mesh_allreduce`` with a wire per axis, hierarchical
  Adasum, ``DistributedOptimizer(route=)``), the two-level eager
  allreduce/allgather (``init(hierarchical_allreduce=True)``), the
  chunked ``alltoall(splits=, chunked=, wire=)`` and
  ``ops.collectives.wired_ppermute``;
* slice 11 — ZeRO and FSDP (``zero.py``): ``ShardedOptimizer`` (stage 1),
  ``ZeroOptimizer`` (stages 1–3) and ``FSDPOptimizer``, their functional
  core ``sharded_init``/``sharded_update``, ``DistributedOptimizer(
  zero_stage=)``, ``auto_shard_threshold``/``should_shard_update``,
  ``integrity.sharded_fingerprint``, ``checkpoint.save_sharded``/
  ``restore_sharded`` (each rank's pieces, resharded on restore), and
  Horovod's capability queries (``gloo_built``, ``nccl_built``, ...: the
  build of torch), ``broadcast_variables``, ``mesh_axes()`` and
  ``AxisPhase``;
* slice 12 — Adasum under the guard and with ``accum_steps``, the D2
  overlap (``DistributedOptimizer(overlap=True)`` for int8_ef and routed
  buckets, the stage-3 prefetch of ``ZeroOptimizer(overlap=True)``;
  ``common/overlap.py``), and elastic training with its launcher: the
  fault plan (``common/faults.py``), ``elastic`` (``run``,
  ``TorchState``, ``ElasticSampler``, preemption), ``checkpoint.
  save_state``/``restore_state``, ``integrity.chaos_poison``/
  ``chaos_perturb``, and ``runner`` (``hvdtpurun-torch``, the elastic
  driver, the rendezvous KV, :func:`run`);
* slice 13 — telemetry and control: the metrics plane, the stall
  inspector, the flight recorder's black box, pod metrics and the
  autoscale engine;
* slice 14 — the autotuner (``common/autotune.py``) and
  ``AutotunedStepper``, which re-plans a live ``DistributedOptimizer``
  (``replan``) or ``ZeroOptimizer`` between two steps; launches beyond
  this machine: the ssh fan-out (one process a slot), LSF hosts, NIC
  discovery (``runner/driver_service.py``), elastic ssh epochs, GPU host
  discovery (``runner/gpu_hosts.py``), ``run(use_ssh=True)``; and
  ``store.py`` (``Store``, ``LocalStore``, ``FsspecStore``,
  ``GCSStore``);
* slice 15 — the native host runtime (``native/*.cc``: the controller's
  wire codec, negotiation table and LRU, the fusion planner, the
  timeline writer, the autotuner's GP/EI core) and the first half of the
  parallel roles (``parallel/``): ``ParallelSpec`` with
  ``init(parallel=)``, ``parallel_spec()`` and ``parallel_mesh()``,
  tensor parallelism (``column_parallel``, ``row_parallel``, ``tp_mlp``,
  ``shard_*``, ``combine_slice_grads``, ``tp_attention_qkv``), sequence
  parallelism (ring, striped ring and Ulysses attention on K5–K7,
  ``ops.collectives.mesh_alltoall``), ``GPT(tp_axis=, seq_parallel=)``
  and ``DistributedOptimizer(parallel=)``;
* slice 16 — the rest of the parallel roles: the GPipe and 1F1B
  pipeline (``pipeline_apply``, ``pipeline_train_step_1f1b``,
  ``pipeline_accumulate_gradients``, ``select_last_stage``), GShard MoE
  (``parallel.moe``, ``GPT(moe_experts=)``), per-layer remat
  (``GPT(remat=True)``), ``DistributedOptimizer``/``ZeroOptimizer(
  parallel=)`` over pp and ep specs, and the respec solver
  (``solve_respec``, ``RespecDecision``, ``min_world``);
* slice 17 — the role-aware elastic path: the autoscale engine under a
  hybrid spec (replica-grouped scoring, the whole-replica floor,
  ``plan_respec``), the pod monitor's role views, the elastic driver's
  respec epochs and the sharded state carried across them
  (``ZeroOptimizer.sharded_tree(names)``/``restore_template``,
  ``models.gpt.global_param_names``); ``DistributedGradFn``,
  ``DistributedOptimizer(op=Adasum, parallel=)``, ``tpu_available``,
  ``collective_ops``;
* slice 18 — the serve levers: shared-prefix forks, speculative
  decoding with a draft model, tp-sharded decode over a head-sharded KV
  ring and the brownout ladder's ``spec_off`` rung;
* slice 19 — the cluster layer: the persistent worker pool
  (``executor``), the parquet shards (``parquet``), the Store-backed
  ``Estimator`` and ``TorchEstimator`` (``estimator``,
  ``torch_estimator``, ``spark.torch``), ``spark.run``/``run_elastic``
  over the task pool (``spark``), ``RayExecutor``/``ElasticRayExecutor``
  (``ray``) and the process-backed Spark and Ray fakes (``testing``);
* slice 20 — the fleet twin (``common/fleetsim.py``: the scenario
  library, trace replay and the virtual-clock serving world, replayed
  byte-identically against the JAX package's banked records) and the
  framework shims over the eager engine: ``tensorflow`` (collectives in
  eager and graph mode, ``DistributedGradientTape``,
  ``DistributedOptimizer``, the Keras callbacks, ``elastic``),
  ``keras``, ``mxnet`` and ``KerasEstimator`` (``keras_estimator``,
  ``spark.keras``).

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request they raise.
Names of the JAX package's API that later slices bring raise
``NotImplementedError`` naming their slice.
"""

import torch

__version__ = "0.1.0"

from .common.basics import (ccl_built, cross_rank, cross_size, cuda_built,
                            ddl_built, device, gloo_built, gloo_enabled, init,
                            is_homogeneous, is_initialized, local_rank,
                            local_size, mpi_built, mpi_enabled,
                            mpi_threads_supported, nccl_built, rank,
                            rocm_built, shutdown, size, tpu_available,
                            xla_built)
from .common.device import resolve_device
from .common import integrity
from .common.exceptions import (AlltoallvLayoutError,
                                CheckpointCorruptError, DivergenceError,
                                DuplicateTensorNameError,
                                HorovodInternalError, HorovodTpuError,
                                HostsUpdatedInterrupt,
                                MismatchError, NonFiniteError,
                                NotInitializedError, StallError,
                                StallTimeoutError,
                                TensorShapeMismatchError)
from .common.faults import recovery_stats
from .common.integrity import (DivergenceDetector, chaos_perturb,
                               chaos_poison, current_loss_scale,
                               observe_guard)
from .common import metrics as _metrics_lib
from .common.metrics import metrics
from .functions import (allgather_object, broadcast_object,
                        broadcast_variables)
from .ops.adasum import adasum_allreduce
from .ops.collectives import (Adasum, Average, AxisPhase, Max, Min, Product,
                              ReduceOp, Sum, WirePlan, broadcast_,
                              quantized_allreduce)
from .ops.compression import Compression
from .ops import collectives as collective_ops
from .ops import eager as _eager
from .optim import (AutotunedStepper, DistributedGradFn,
                    DistributedOptimizer, accumulate_gradients,
                    broadcast_optimizer_state, broadcast_parameters,
                    observe_ef_residual, resolve_remat_policy, StepTimer)
from .process_set import (ProcessSet, add_process_set,
                          member_engine as _engine, remove_process_set)
from .sync_batch_norm import SyncBatchNorm
from .zero import (FSDPOptimizer, ShardedOptimizer, ZeroOptimizer,
                   auto_shard_threshold, sharded_init, sharded_update,
                   should_shard_update)
from . import callbacks, checkpoint, elastic
from .checkpoint import (CheckpointManager, ObjectStore, restore_sharded,
                         restore_state, save_sharded, save_state)
from .runner import run
from .data import (BackgroundPrefetcher, DeviceInfeed, ElasticSampler,
                   infeed_pipeline, prefetch_to_device, shard_batch)
from .parallel.pipeline import (pipeline_accumulate_gradients,
                                pipeline_apply, pipeline_train_step_1f1b,
                                select_last_stage)
from .parallel.respec import RespecDecision, min_world, solve_respec
from .parallel.spec import ParallelSpec
from .parallel.tensor_parallel import (column_parallel,
                                       combine_slice_grads, row_parallel,
                                       shard_column, shard_head_rows,
                                       shard_heads, shard_row,
                                       tp_attention_qkv, tp_mlp)

__all__ = [
    "Adasum", "AlltoallvLayoutError", "AutotunedStepper", "Average",
    "BackgroundPrefetcher",
    "CheckpointCorruptError", "CheckpointManager", "Compression",
    "DeviceInfeed", "DistributedGradFn", "DistributedOptimizer",
    "DivergenceDetector", "__version__",
    "collective_ops", "serve", "tpu_available",
    "DivergenceError", "DuplicateTensorNameError", "ElasticSampler",
    "HorovodInternalError", "HorovodTpuError", "HostsUpdatedInterrupt",
    "Max", "Min",
    "MismatchError", "NonFiniteError", "NotInitializedError",
    "StallError", "StallTimeoutError", "StepTimer", "flight_recorder",
    "start_metrics_server", "stop_metrics_server",
    "AxisPhase", "FSDPOptimizer", "ShardedOptimizer", "ZeroOptimizer",
    "auto_shard_threshold", "broadcast_variables", "ccl_built",
    "cuda_built", "ddl_built", "gloo_built", "gloo_enabled", "mesh_axes",
    "mpi_built", "mpi_enabled", "mpi_threads_supported", "nccl_built",
    "restore_sharded", "rocm_built", "save_sharded", "sharded_init",
    "sharded_update", "should_shard_update", "xla_built",
    "ObjectStore", "ProcessSet", "Product", "ReduceOp", "Sum",
    "SyncBatchNorm", "TensorShapeMismatchError", "WirePlan",
    "accumulate_gradients", "add_process_set", "adasum_allreduce",
    "allgather", "allgather_async", "allgather_object", "allgatherv",
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "alltoall", "alltoall_async", "barrier", "broadcast", "broadcast_",
    "broadcast_async", "broadcast_async_", "broadcast_object",
    "broadcast_optimizer_state", "broadcast_parameters", "callbacks",
    "chaos_perturb", "chaos_poison", "checkpoint", "cross_rank", "cross_size", "current_loss_scale",
    "device", "elastic", "grouped_allgather",
    "grouped_allreduce", "grouped_allreduce_", "grouped_reducescatter",
    "infeed_pipeline", "init", "integrity", "is_homogeneous",
    "is_initialized", "join",
    "local_rank", "local_size", "metrics", "observe_ef_residual",
    "observe_guard", "poll", "prefetch_to_device", "quantized_allreduce",
    "rank", "recovery_stats", "reducescatter", "remove_process_set",
    "resolve_device",
    "resolve_remat_policy", "restore_state", "run", "save_state",
    "shard_batch", "shutdown", "size",
    "sparse_allreduce_async", "start_timeline", "stop_timeline",
    "synchronize",
    "ParallelSpec", "parallel_spec", "parallel_mesh",
    "pipeline_accumulate_gradients", "pipeline_apply",
    "pipeline_train_step_1f1b", "select_last_stage",
    "column_parallel", "row_parallel", "tp_mlp", "tp_attention_qkv",
    "shard_column", "shard_row", "shard_heads", "shard_head_rows",
    "combine_slice_grads",
]


def __getattr__(name):
    # The serving plane, the cluster layer and the framework shims are
    # imported on first use, as in the JAX package: they pull the models,
    # the scheduler, the Store, the cluster adapters and TensorFlow.
    if name in ("executor", "store", "estimator", "spark", "serve",
                "tensorflow", "mxnet"):
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module 'horovod_tpu_torch' has no attribute {name!r}")


# -- the eager API (the JAX package's signatures, one rank per process) ----
#
# ``_engine(process_set)`` is the world's engine or a registered set's.
# Async handles of every engine live in the world engine's table, which
# ``poll`` and ``synchronize`` read.



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


def allreduce_(tensor, op: ReduceOp = Average, name=None, process_set=None):
    """In-place :func:`allreduce` (Horovod's ``allreduce_``): writes the
    reduction into ``tensor`` and returns ``tensor``."""
    tensor.copy_(allreduce(tensor, op, name, process_set=process_set))
    return tensor


def allreduce_async(x, op: ReduceOp = Average, name=None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0, compression=None,
                    process_set=None) -> int:
    """:func:`allreduce`, issued: returns a handle for :func:`poll` and
    :func:`synchronize` (which returns the result). Handles live in the
    world engine's table, whichever engine runs the collective."""
    e = _engine(process_set)
    return _engine().async_call(e.allreduce, x, op, name, prescale_factor,
                                postscale_factor, compression)


def allreduce_async_(tensor, op: ReduceOp = Average, name=None,
                     process_set=None) -> int:
    """In-place :func:`allreduce_async` (Horovod's ``torch/mpi_ops.py``
    ``allreduce_async_``): returns a handle whose :func:`synchronize`
    writes the reduction of every rank's ``tensor`` into ``tensor`` and
    returns ``tensor``."""
    e = _engine(process_set)
    return _engine().async_call(_eager.InPlace,
                                e.allreduce(tensor, op, name), tensor)


def grouped_allreduce(tensors, op: ReduceOp = Average, name=None,
                      compression=None, prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0, process_set=None):
    """Allreduce a list of tensors through fusion buckets; returns the
    list of results."""
    return _engine(process_set).allreduce_tree(
        tensors, op, name, compression, prescale_factor,
        postscale_factor).wait()


def grouped_allreduce_(tensors, op: ReduceOp = Average, name=None,
                       prescale_factor: float = 1.0,
                       postscale_factor: float = 1.0, compression=None,
                       process_set=None):
    """In-place :func:`grouped_allreduce` (Horovod's
    ``grouped_allreduce_``, in the argument order of the JAX package's
    PyTorch surface: scales before ``compression``): writes each
    reduction into its tensor and returns ``tensors``."""
    outs = grouped_allreduce(tensors, op, name, compression,
                             prescale_factor, postscale_factor, process_set)
    for t, o in zip(tensors, outs):
        t.copy_(o)
    return tensors


def sparse_allreduce_async(tensor, name=None, op: ReduceOp = Average,
                           process_set=None):
    """Allreduce a sparse COO tensor (Horovod's
    ``sparse_allreduce_async``): every rank's values and indices ride a
    ragged :func:`allgatherv`, the sum of the sparse operands. Returns a
    zero-argument callable that waits and returns the reduced sparse
    tensor: duplicates coalesced (summed in the values' dtype), then for
    AVERAGE divided by the world size in fp64 (rounded back for integer
    values). Only Sum and Average are defined."""
    if not tensor.is_sparse:
        raise ValueError("sparse_allreduce_async needs a sparse COO "
                         "tensor; use allreduce/allreduce_async for dense "
                         "tensors")
    op = ReduceOp(op)
    if op not in (Average, Sum):
        raise NotImplementedError("sparse allreduce supports Average/Sum")
    e = _engine(process_set)
    t = tensor.coalesce()
    # COO indices are (ndim, nnz): gather along nnz, so transpose first.
    vals = e.allgatherv(t.values(), f"{name}.values" if name else None)
    idxs = e.allgatherv(t.indices().t().contiguous(),
                        f"{name}.indices" if name else None)
    # Only the shape and dtype outlive the call: the handle must not pin
    # the input gradient.
    shape, dtype, n = tuple(tensor.shape), tensor.dtype, e.size

    def handle():
        out = torch.sparse_coo_tensor(idxs.wait().t(), vals.wait(),
                                      size=shape).coalesce()
        values = out.values()
        if op == Average:
            values = values.to(torch.float64) / n
            if not dtype.is_floating_point:
                values = values.round()
        return torch.sparse_coo_tensor(out.indices(), values.to(dtype),
                                       size=shape)

    return handle


def allgather(x, name=None, process_set=None):
    """Every rank's ``x`` (one shape on every rank) concatenated along
    dim 0."""
    return _engine(process_set).allgather(x, name).wait()


def allgatherv(x, name=None, process_set=None):
    """Every rank's rows concatenated along dim 0, where ranks may hold
    different row counts."""
    return _engine(process_set).allgatherv(x, name).wait()


def allgather_async(x, name=None, process_set=None) -> int:
    e = _engine(process_set)
    return _engine().async_call(e.allgather, x, name)


def grouped_allgather(tensors, name=None, process_set=None):
    """:func:`allgather` of each tensor of a list (issued together)."""
    e = _engine(process_set)
    pend = [e.allgather(v, f"{name}.{i}" if name else None)
            for i, v in enumerate(tensors)]
    return [p.wait() for p in pend]


def _set_root(root_rank: int, process_set) -> int:
    """A broadcast root, a GLOBAL rank, as its position in the set."""
    if process_set is None:
        return root_rank
    if root_rank not in process_set.ranks:
        raise ValueError(f"root_rank {root_rank} is not a member of "
                         f"{process_set!r}")
    return process_set.ranks.index(root_rank)


def broadcast(x, root_rank: int = 0, name=None, process_set=None):
    """``root_rank``'s ``x`` as a new tensor on every rank (with
    ``process_set``, ``root_rank`` is still a global rank)."""
    e = _engine(process_set)
    return e.broadcast(x, _set_root(root_rank, process_set), name).wait()


def broadcast_async(x, root_rank: int = 0, name=None,
                    process_set=None) -> int:
    e = _engine(process_set)
    return _engine().async_call(e.broadcast, x,
                                _set_root(root_rank, process_set), name)


def broadcast_async_(tensor, root_rank: int = 0, name=None,
                     process_set=None) -> int:
    """In-place :func:`broadcast_async` (Horovod's ``broadcast_async_``):
    :func:`synchronize` writes ``root_rank``'s tensor into ``tensor`` and
    returns ``tensor``."""
    e = _engine(process_set)
    return _engine().async_call(_eager.InPlace, e.broadcast(
        tensor, _set_root(root_rank, process_set), name), tensor)


def alltoall(x, name=None, splits=None, process_set=None, chunked=None,
             wire=None):
    """Even all-to-all (dim 0 in ``size`` equal chunks, chunk ``j`` to
    rank ``j``), or with ``splits`` — this rank's send counts — the
    uneven one, whose receive counts are negotiated. ``wire`` ("bf16",
    "int8", "auto" or a ``Compression`` class) compresses the even
    exchange's payload, or the uneven one's chunked hops (``chunked``:
    True forces the per-hop padded exchange, False the flat one, None
    takes the chunked one for a wire and the flat one otherwise)."""
    return _engine(process_set).alltoall(x, name, splits=splits,
                                         chunked=chunked, wire=wire).wait()


def alltoall_async(x, name=None, process_set=None) -> int:
    """The even :func:`alltoall`, issued: :func:`synchronize` returns the
    chunks received, in source-rank order."""
    e = _engine(process_set)
    return _engine().async_call(e.alltoall, x, name)


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


def start_timeline(filename: str, mark_cycles: bool = False,
                   xprof_dir=None) -> None:
    """Write a Chrome trace of the eager collectives to ``filename``: a
    begin event at each submit and an end event at its synchronize.
    ``xprof_dir`` also runs a ``torch.profiler`` trace, written there as
    a chrome trace when the timeline stops."""
    from .common import basics as _basics

    _basics.context().timeline.start(filename, mark_cycles, xprof_dir)


def mesh_axes() -> tuple:
    """The routing axes of this world, fast axis first
    (``common.topology.MeshAxis``: name, size, link tier) — the
    ``init(mesh_shape=)`` / ``HVD_TPU_MESH_SHAPE`` factorization, else
    cross x local from the launcher, else the flat axis."""
    from .common import basics as _basics

    return _basics.context().mesh_axes


def stop_timeline() -> None:
    from .common import basics as _basics

    _basics.context().timeline.stop()


def parallel_spec():
    """The hybrid :class:`ParallelSpec` of ``init(parallel=)`` /
    ``HVD_TPU_PARALLEL``, else None; pass it explicitly to
    ``DistributedOptimizer(parallel=...)``."""
    from .common import basics as _basics

    return _basics.context().parallel_spec


def parallel_mesh():
    """The role-named axes of :func:`parallel_spec` — a dict from role to
    ``common.topology.Axis`` (its subgroup, size, this rank's index and
    the global ranks of its line), slow axis first; else None."""
    from .common import basics as _basics

    ctx = _basics.context()
    return dict(ctx.parallel_axes) if ctx.parallel_spec is not None \
        else None


def start_metrics_server(port: int = 0) -> int:
    """Start (or return) the Prometheus ``/metrics`` endpoint on a
    background HTTP thread; returns the bound port (``port=0`` binds an
    ephemeral one). ``/metrics.json`` serves the ``metrics()`` snapshot.
    Samples carry ``rank``/``size``/``host`` labels once ``init()`` has
    run, so a pod scrape aggregates by rank."""
    return _metrics_lib.serve(port)


def stop_metrics_server() -> None:
    _metrics_lib.stop_serving()


def flight_recorder():
    """The process-wide flight recorder: the ring of the last N
    collective events and the black-box dump.
    ``flight_recorder().events()`` is the live ring;
    ``flight_recorder().dump("manual")`` writes a black box on demand
    (the payload SIGUSR2 or a fatal stall produces). Usable before
    ``init()``: the env-configured recorder is made on first use."""
    from .common import flightrec as _flightrec_lib

    return _flightrec_lib.recorder()
