"""Runtime context of the port: ``init``/``shutdown`` and the rank queries,
over ``torch.distributed``.

The port of ``horovod_tpu/common/basics.py``'s ``init`` contract (a bare
re-``init()`` is idempotent; ``init`` with overrides on a live context
raises) and of the rank identity ``horovod_tpu/common/topology.py`` reads
from a launcher's environment:

* ``HVD_TPU_COORDINATOR`` (``host:port`` of rank 0's rendezvous),
  ``HVD_TPU_NUM_PROC`` and ``HVD_TPU_PROC_ID`` give the world; with none
  set the world is this one process;
* ``HVD_TPU_LOCAL_RANK``/``HVD_TPU_LOCAL_SIZE`` place the process on its
  host (default: every rank on one host, local rank = rank).

Device rule: ``init()`` takes the GPU of its local rank and the ``nccl``
backend; it takes the CPU and ``gloo`` only when the caller passes
``device="cpu"``, and without a GPU and without that request it raises.

Backend rule: ``backend="gloo"`` keeps the GPU but reduces through gloo,
which stages CUDA tensors through host memory — the port's counterpart
of reference Horovod's ``horovodrun --gloo``, and the only way to run
more ranks on a host than it has GPUs (NCCL refuses two ranks on one
GPU). ``nccl`` (or the default) with more local ranks than GPUs raises
before NCCL is reached, naming ``backend="gloo"``; there is no silent
switch.

Eager engine: ``init()`` also builds the eager collective engine
(``ops/eager.py``) and its timeline (``common/timeline.py``), and, when
the world has more than one rank, the controller that negotiates its
collectives (``common/controller.py``) over the process group's c10d
store, its keys namespaced per ``init()`` generation. ``shutdown()``
synchronizes the engine's outstanding handles and stops the timeline
before it destroys the process group.

Process sets and ``comm=`` subset communicators are not ported yet.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional, Union

import torch
import torch.distributed as dist

from . import config as config_lib
from .device import resolve_device
from .exceptions import NotInitializedError


@dataclasses.dataclass
class Context:
    rank: int
    size: int
    local_rank: int
    local_size: int
    device: torch.device
    backend: str
    config: config_lib.Config
    controller: Any = None      # common.controller.Controller when size > 1
    engine: Any = None          # ops.eager.EagerEngine
    timeline: Any = None        # common.timeline.Timeline


_context: Optional[Context] = None
_context_lock = threading.Lock()
_init_count = 0                 # init() generations, for controller keys


def _world():
    """(rank, size, coordinator or None) from the launcher's env."""
    coord = config_lib.runtime_env("COORDINATOR")
    nproc = config_lib.runtime_env("NUM_PROC")
    if not (coord and nproc):
        return 0, 1, None
    size = int(nproc)
    rank = int(config_lib.runtime_env("PROC_ID", "0"))
    if not 0 <= rank < size:
        raise ValueError(f"HVD_TPU_PROC_ID={rank} is outside a world of "
                         f"HVD_TPU_NUM_PROC={size}")
    return rank, size, coord


_BACKENDS = ("nccl", "gloo")


def _resolve_backend(dev: torch.device, backend: Optional[str],
                     local_size: int) -> str:
    """The process group's backend for ``dev`` (see the module's backend
    rule); raises on a combination that cannot work."""
    if backend is not None and backend not in _BACKENDS:
        raise ValueError(f"init(): backend must be one of {_BACKENDS} or "
                         f"None, got {backend!r}")
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("init(): the nccl backend needs the GPU; the "
                             "CPU reduces through gloo")
        return "gloo"
    if dev.type != "cuda":
        raise ValueError(f"init(): unsupported device {dev}")
    backend = backend or "nccl"
    gpus = torch.cuda.device_count()
    if backend == "nccl" and local_size > gpus:
        raise ValueError(
            f"init(): {local_size} ranks on this host but {gpus} GPU(s); "
            "NCCL takes one GPU per rank. Pass init(backend=\"gloo\") to "
            "run several ranks on one GPU (collectives then stage through "
            "host memory)")
    return backend


def init(comm=None, process_sets=None,
         device: Optional[Union[str, torch.device]] = None,
         backend: Optional[str] = None,
         **config_overrides) -> Context:
    """Initialize the runtime (idempotent for a bare call).

    ``device`` is ``None`` (the GPU of this process's local rank) or
    ``"cpu"``. ``backend`` is ``None`` (``nccl`` on the GPU, ``gloo`` on
    the CPU), ``"gloo"`` (on either) or ``"nccl"``. ``config_overrides``
    are :class:`~.config.Config` fields and win over the environment."""
    global _context, _init_count
    if comm is not None or process_sets:
        raise NotImplementedError(
            "comm= and process_sets= are not ported yet; they come with "
            "the process-set slice of the port")
    with _context_lock:
        if _context is not None:
            if device is not None or backend is not None \
                    or config_overrides:
                raise ValueError(
                    "init() called with device/backend/config overrides "
                    "but the runtime is already initialized; call "
                    "shutdown() first to re-initialize with different "
                    "settings")
            return _context
        cfg = config_lib.Config.from_env(**config_overrides)
        dev = resolve_device(device)
        rank, size, coord = _world()
        local_rank = int(config_lib.runtime_env("LOCAL_RANK", str(rank)))
        local_size = int(config_lib.runtime_env("LOCAL_SIZE", str(size)))
        backend = _resolve_backend(dev, backend, local_size)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda",
                                   local_rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        if coord is None:
            # A world of one: an in-process store, no port to pick.
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        else:
            dist.init_process_group(backend, init_method=f"tcp://{coord}",
                                    rank=rank, world_size=size)
        from ..ops.eager import EagerEngine
        from .controller import Controller, StoreTransport
        from .timeline import Timeline

        _init_count += 1
        controller = None
        if size > 1:
            controller = Controller(
                rank, size,
                StoreTransport(dist.distributed_c10d._get_default_store()),
                timeout_s=cfg.stall_check_time_seconds,
                incarnation=_init_count)
        timeline = Timeline()
        try:
            engine = EagerEngine(cfg, dev, rank, size,
                                 controller=controller, timeline=timeline)
        except Exception:
            dist.destroy_process_group()
            raise
        _context = Context(rank, size, local_rank, local_size, dev, backend,
                           cfg, controller, engine, timeline)
        return _context


def shutdown() -> None:
    """Synchronize the eager engine's outstanding handles, stop the
    timeline and tear the process group down; a later ``init()`` starts
    afresh."""
    global _context
    with _context_lock:
        if _context is not None:
            try:
                _context.engine.drain()
                _context.timeline.stop()
            finally:
                dist.destroy_process_group()
                _context = None


def is_initialized() -> bool:
    return _context is not None


def context() -> Context:
    if _context is None:
        raise NotInitializedError()
    return _context


def rank() -> int:
    return context().rank


def size() -> int:
    return context().size


def local_rank() -> int:
    return context().local_rank


def local_size() -> int:
    return context().local_size


def device() -> torch.device:
    """The device this process's collectives and model run on."""
    return context().device
