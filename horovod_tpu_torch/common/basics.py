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

Telemetry: ``init()`` pins the process to its core
(``HVD_TPU_THREAD_AFFINITY``), starts the stall inspector's watchdog
(``common/stall.py``), installs the flight recorder and its SIGUSR2
handler (``common/flightrec.py``), stamps ``rank``/``size``/``host`` onto
every metric sample, and starts the metrics dump and the ``/metrics``
endpoint when asked (``metrics_file``, ``metrics_port``), advertising the
port over the rendezvous KV for the elastic driver's pod monitor.
``shutdown()`` stops what ``init()`` started; at interpreter exit the
shutdown sequence (``common/shutdown.py``) runs it after the flight
recorder's final box.

Topology (``common/topology.py``): ``init()`` resolves the routing
mesh (``init(mesh_shape=)`` / ``HVD_TPU_MESH_SHAPE``, else cross x local
from the launcher, else flat) and makes one ``torch.distributed``
subgroup per line of every axis, on every rank in one fixed order; the
context's :class:`~.topology.Axis` handles (``context().axes``) are
what the collectives of ``ops/collectives.py`` take as ``axis=``. Every
rank must pass the same mesh shape: the shapes are compared through the
controller's store before any group is made, and a mismatch raises.

``init(comm=[ranks])`` makes a world of the listed processes alone: each
member calls it with the same list and becomes rank ``comm.index(its
launcher rank)``; a process not in the list raises. Disjoint comm worlds
may start at once: each rendezvous under its own key prefix (the comm
list and how many times this process has joined it) on one store at the
launcher's coordinator, which the launcher's rank 0 hosts from its first
``init(comm=)`` for the life of its process. So rank 0 is a member of
some comm, and at exit waits (up to ``stall_check_time_seconds``) for
the comm worlds that are still up to shut down. A job uses either
``init(comm=)`` or the plain ``init()`` on one coordinator.
``process_sets=`` registers :class:`~..process_set.ProcessSet` s at
once, as :func:`add_process_set` does afterwards.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from . import config as config_lib
from . import shutdown as shutdown_lib
from . import topology as topo_lib
from .device import resolve_device
from .exceptions import NotInitializedError

logger = logging.getLogger("horovod_tpu_torch")


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
    topology: Optional[topo_lib.Topology] = None
    #: The routing axes, fast first (``topology.mesh_axes``), and the
    #: axis handles by name ("hvd" is the world).
    mesh_axes: tuple = ()
    axes: Dict[str, topo_lib.Axis] = dataclasses.field(default_factory=dict)
    #: Registered process sets, in registration order, and how many were
    #: ever registered (the key of each registration's agreement round).
    process_sets: List[Any] = dataclasses.field(default_factory=list)
    process_set_seq: int = 0
    #: Under an elastic launch: a callable returning True once the
    #: driver's topology version moved (``State.check_host_updates``).
    host_update_notifier: Any = None
    #: Telemetry: the stall inspector (``common/stall.py``), the flight
    #: recorder installed as the process's (``common/flightrec.py``), the
    #: bound ``/metrics`` port (None: not serving) and which export
    #: surfaces this context started (a dump or server the user started
    #: outlives the context).
    stall: Any = None
    flightrec: Any = None
    metrics_port: Optional[int] = None
    owns_metrics_server: bool = False
    owns_metrics_dump: bool = False
    #: The runtime autotuner (``common/autotune.py``) when
    #: ``init(autotune=True)`` / ``HVD_TPU_AUTOTUNE=1``, else None.
    autotuner: Any = None
    #: The hybrid ParallelSpec of ``init(parallel=)`` /
    #: ``HVD_TPU_PARALLEL`` (None: role-blind) and its role-named axes
    #: (``parallel/mesh.py``), also entered in :attr:`axes`.
    parallel_spec: Any = None
    parallel_axes: Dict[str, topo_lib.Axis] = dataclasses.field(
        default_factory=dict)

    def fusion_threshold(self) -> int:
        """The live fusion threshold: the autotuner's current one while
        a tuner runs, else the configured one (the engine's resolver). A
        ``DistributedOptimizer`` or a grouped allreduce made without an
        explicit threshold takes this value."""
        return self.engine.fusion_threshold()

    @property
    def world_axis(self) -> topo_lib.Axis:
        return self.axes["hvd"]

    def axis(self, name: str) -> topo_lib.Axis:
        """The handle of mesh axis ``name``; raises naming the known
        axes."""
        try:
            return self.axes[name]
        except KeyError:
            raise ValueError(
                f"no mesh axis {name!r} in this world (axes "
                f"{sorted(self.axes)}; set init(mesh_shape=) or "
                "HVD_TPU_MESH_SHAPE for a multi-axis mesh)") from None

    def hier_axes(self):
        """``(cross, local)`` of a 2-D mesh, else None."""
        names = [a.name for a in self.mesh_axes]
        if sorted(names) == ["cross", "local"]:
            return self.axes["cross"], self.axes["local"]
        return None


_context: Optional[Context] = None
_context_lock = threading.Lock()
_init_count = 0                 # init() generations, for controller keys
# The comm worlds' rendezvous: the coordinator's store (one a process),
# how many times this process joined each comm list there, and the store
# this process's live comm world is counted on.
_comm_stores: Dict[str, Any] = {}
_comm_joins: Dict[tuple, int] = {}
_comm_live: Optional[Any] = None
_COMM_LIVE_KEY = "hvd_tpu/comm/live"
# The plain worlds' rendezvous: one TCPStore a coordinator for the life
# of the process and how many worlds this process joined on it, so a
# re-init (the elastic reset) meets under a fresh prefix.
_world_stores: Dict[str, Any] = {}
_world_joins: Dict[str, int] = {}


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
    are :class:`~.config.Config` fields and win over the environment
    (``mesh_shape``, ``route``, ``hierarchical_allreduce`` ... included).
    ``comm`` lists the launcher ranks that form this world (every member
    passes the same list); ``process_sets`` are registered in order once
    the world is up (every rank passes the same sets)."""
    global _context, _init_count
    with _context_lock:
        if _context is not None:
            if device is not None or backend is not None \
                    or config_overrides or comm is not None or process_sets:
                raise ValueError(
                    "init() called with comm/process_sets/device/backend/"
                    "config overrides but the runtime is already "
                    "initialized; call shutdown() first to re-initialize "
                    "with different settings")
            return _context
        cfg = config_lib.Config.from_env(**config_overrides)
        from . import faults as faults_lib

        faults_lib.refresh_from_env()
        dev = resolve_device(device)
        launch_rank, size, coord = _world()
        members = None if comm is None else _members(comm, launch_rank,
                                                      size)
        rank, size = (launch_rank, size) if members is None else \
            (members.index(launch_rank), len(members))
        local_rank = int(config_lib.runtime_env("LOCAL_RANK", str(rank)))
        local_size = int(config_lib.runtime_env("LOCAL_SIZE", str(size)))
        # Host-core pinning before this process starts its threads (the
        # gloo workers, the stall watchdog, the D2 worker inherit it).
        from .affinity import parse_and_set_affinity

        parse_and_set_affinity(cfg.thread_affinity, local_size, local_rank)
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
        elif members is not None:
            store = _comm_store(coord, launch_rank, members, cfg)
            try:
                dist.init_process_group(backend, store=store, rank=rank,
                                        world_size=size)
            except Exception:
                _leave_comm_world()
                raise
        else:
            dist.init_process_group(backend,
                                    store=_world_store(coord, rank, size,
                                                       cfg),
                                    rank=rank, world_size=size,
                                    **_pg_timeout(cfg))
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
                # A comm world's store prefix is already its own join's,
                # and its members may have joined other worlds before.
                incarnation=_init_count if members is None else 0)
        timeline = Timeline()
        stall = None
        try:
            topo = topo_lib.Topology(rank, size, local_rank, local_size)
            maxes = _mesh_axes(topo, cfg, controller)
            axes = topo_lib.build_axes(maxes, rank, size, dist.new_group)
            ctx = Context(rank, size, local_rank, local_size, dev, backend,
                          cfg, controller, None, timeline, topo, maxes, axes)
            _build_parallel(ctx, controller)
            stall = _start_stall_and_flightrec(ctx)
            if ctx.parallel_spec is not None and ctx.flightrec is not None:
                ctx.flightrec.role = ctx.parallel_spec.role_label(rank)
            if cfg.autotune:
                # The JAX context's tuner: the eager engine feeds it in a
                # world of one, AutotunedStepper drives it otherwise.
                from .autotune import Autotuner

                ctx.autotuner = Autotuner(
                    warmup_samples=cfg.autotune_warmup_samples,
                    steps_per_sample=cfg.autotune_steps_per_sample,
                    log_file=cfg.autotune_log)
            ctx.engine = EagerEngine(cfg, dev, rank, size,
                                     controller=controller,
                                     timeline=timeline,
                                     hier_mesh=ctx.hier_axes(),
                                     stall_inspector=stall,
                                     autotuner=ctx.autotuner,
                                     axis=ctx.world_axis)
        except Exception:
            if stall is not None:
                stall.stop_watchdog()
            dist.destroy_process_group()
            _leave_comm_world()
            raise
        if cfg.elastic and config_lib.runtime_env("RENDEZVOUS"):
            ctx.host_update_notifier = _host_update_notifier(
                config_lib.runtime_env("RENDEZVOUS"))
        _start_metrics(ctx)
        _context = ctx
        # One ordered teardown at exit (common/shutdown.py): after the
        # flight recorder's final box, before the recovery-stats dump.
        shutdown_lib.register("context", _shutdown_at_exit,
                              shutdown_lib.CONTEXT_PRIORITY)
    if process_sets:
        from ..process_set import add_process_set

        for ps in process_sets:
            add_process_set(ps)
    return _context


def _start_stall_and_flightrec(ctx: Context):
    """The stall inspector and its watchdog, and the flight recorder
    installed as the process's, wired to each other; SIGUSR2 arms the
    on-demand black box (main thread only, best-effort). Returns the
    inspector."""
    from . import flightrec as flightrec_lib
    from .stall import StallInspector

    cfg = ctx.config
    stall = StallInspector(cfg.stall_check_time_seconds,
                           cfg.stall_shutdown_time_seconds,
                           cfg.stall_check_disable,
                           fatal_mode=cfg.stall_fatal)
    stall.start_watchdog()
    ctx.stall = stall
    # rank= is the fallback; HVD_TPU_PROC_ID wins inside the
    # constructor, as for the metrics labels below.
    ctx.flightrec = flightrec_lib.install(flightrec_lib.FlightRecorder(
        size=cfg.flightrec_size, directory=cfg.flightrec_dir,
        enabled=cfg.flightrec, rank=ctx.rank))
    ctx.flightrec._stall_inspector = stall
    flightrec_lib.install_signal_handler()
    return stall


def _start_metrics(ctx: Context) -> None:
    """Stamp the rank identity onto every exported sample (``rank``,
    ``size`` and, under a launcher, ``host``), then start the export
    surfaces the config asks for: the JSON-lines dump and the
    ``/metrics`` endpoint, whose port is advertised over the rendezvous
    KV for the pod monitor. A taken fixed port falls back to an
    ephemeral one: telemetry never fails ``init()``."""
    from . import metrics as metrics_lib

    if not metrics_lib.enabled():
        return
    cfg = ctx.config
    labels = {"rank": str(ctx.rank), "size": str(ctx.size)}
    host_label = config_lib.runtime_env("HOSTNAME")
    if host_label:
        labels["host"] = host_label
    metrics_lib.set_global_labels(**labels)
    if cfg.metrics_trace_bridge:
        metrics_lib.enable_trace_bridge(True)
    if cfg.metrics_file:
        ctx.owns_metrics_dump = metrics_lib.dumping_path() is None
        metrics_lib.start_file_dump(cfg.metrics_file,
                                    cfg.metrics_interval_s)
    if cfg.metrics_port < 0:
        return
    already = metrics_lib.serving_port()
    try:
        ctx.metrics_port = metrics_lib.serve(cfg.metrics_port)
    except OSError as e:
        logger.warning(
            "metrics: port %d unavailable (%s); binding an ephemeral "
            "port instead — pass --metrics-port 0 with several workers "
            "a host", cfg.metrics_port, e)
        try:
            ctx.metrics_port = metrics_lib.serve(0)
        except OSError as e2:
            logger.warning("metrics: /metrics endpoint disabled (%s)", e2)
            return
    ctx.owns_metrics_server = already is None
    logger.info("metrics: Prometheus /metrics endpoint on port %d",
                ctx.metrics_port)
    from . import podmon as podmon_lib

    podmon_lib.register_endpoint(ctx.metrics_port, rank=ctx.rank)


def _pg_timeout(cfg) -> dict:
    """Under an elastic launch the process group's timeout is the stall
    inspector's fatal bound (``stall_shutdown_time_seconds``), or its
    warning age (``stall_check_time_seconds``) when no fatal bound is
    set: a survivor whose peer died mid-collective raises instead of
    waiting out torch's 30 minutes, and a peer that is only slow past
    the warning age is not taken for dead."""
    if not cfg.elastic:
        return {}
    import datetime

    seconds = (cfg.stall_shutdown_time_seconds
               if cfg.stall_shutdown_time_seconds > 0
               else cfg.stall_check_time_seconds)
    return {"timeout": datetime.timedelta(seconds=seconds)}


def _world_store(coord: str, rank: int, size: int, cfg):
    """The plain world's rendezvous: the coordinator's TCPStore (rank 0
    hosts it, made once a process) under a prefix of this process's
    join count there, so a re-``init()`` after ``shutdown()`` (the
    elastic reset) meets under fresh keys."""
    store = _world_stores.get(coord)
    if store is None:
        import datetime

        host, port = coord.rsplit(":", 1)
        timeout = datetime.timedelta(
            seconds=cfg.stall_check_time_seconds if cfg.elastic else 300)
        store = dist.TCPStore(host, int(port), size, is_master=rank == 0,
                              timeout=timeout, wait_for_workers=False)
        _world_stores[coord] = store
    joins = _world_joins.get(coord, 0)
    _world_joins[coord] = joins + 1
    return dist.PrefixStore(f"hvd_tpu/world/{joins}", store)


def _host_update_notifier(rdv_addr: str):
    """The elastic host-update channel: True once the driver's
    ``elastic/topology_version`` moved (the JAX package's
    ``_make_host_update_notifier``) — since the version the driver
    started this worker under (``HVD_TPU_TOPOLOGY_VERSION``), so a
    change during the worker's start-up is not missed; without it,
    since the first read."""
    from ..runner.rendezvous import RendezvousClient

    host, port = rdv_addr.rsplit(":", 1)
    client = RendezvousClient(host, int(port), timeout_s=5.0)
    last_seen = {"v": config_lib.runtime_env("TOPOLOGY_VERSION")}
    warned = {"auth": False}

    def notifier() -> bool:
        import urllib.error

        try:
            raw = client.get("elastic", "topology_version")
        except urllib.error.HTTPError as e:
            if e.code == 403 and not warned["auth"]:
                warned["auth"] = True
                logger.warning(
                    "elastic host-update polling rejected (403): "
                    "HVD_TPU_RENDEZVOUS_SECRET missing or mismatched — "
                    "topology changes will NOT be observed")
            return False
        except OSError:
            return False
        if raw is None:
            return False
        v = raw.decode()
        if last_seen["v"] is None:
            last_seen["v"] = v
            return False
        if v != last_seen["v"]:
            last_seen["v"] = v
            return True
        return False

    return notifier


def _members(comm: Sequence[int], rank: int, size: int) -> List[int]:
    """``comm``'s launcher ranks, checked: distinct, in the launched
    world, and this process among them."""
    members = [int(r) for r in comm]
    if not members or len(set(members)) != len(members) \
            or any(not 0 <= r < size for r in members):
        raise ValueError(f"init(comm={list(comm)}): needs distinct ranks of "
                         f"the launched world of {size}")
    if rank not in members:
        raise ValueError(
            f"init(comm={members}): process {rank} is not in comm; only "
            "the member processes call init(comm=...)")
    return members


def _comm_store(coord: str, launch_rank: int, members: List[int], cfg):
    """The rendezvous of the comm world ``members``: a prefix of its own
    on the coordinator's store (hosted by launcher rank 0), counted live
    until :func:`shutdown`."""
    global _comm_live
    store = _comm_stores.get(coord)
    if store is None:
        host, port = coord.rsplit(":", 1)
        master = launch_rank == 0
        store = dist.TCPStore(host, int(port), is_master=master,
                              wait_for_workers=False)
        _comm_stores[coord] = store
        if master:
            # In the shutdown sequence after this process's own context
            # shutdown, which leaves its comm world.
            timeout_s = cfg.stall_check_time_seconds
            shutdown_lib.register(
                f"comm_worlds:{coord}",
                lambda: _await_comm_worlds(store, timeout_s),
                shutdown_lib.CONTEXT_PRIORITY + 5)
    key = (coord, tuple(members))
    joins = _comm_joins.get(key, 0)
    _comm_joins[key] = joins + 1
    store.add(_COMM_LIVE_KEY, 1)
    _comm_live = store
    return dist.PrefixStore(
        f"hvd_tpu/comm/{'-'.join(map(str, members))}/{joins}", store)


def _await_comm_worlds(store, timeout_s: float) -> None:
    """At rank 0's exit: keep the store up until every comm world that
    joined it has shut down, or ``timeout_s`` passed."""
    deadline = time.monotonic() + timeout_s
    while store.add(_COMM_LIVE_KEY, 0) > 0 and time.monotonic() < deadline:
        time.sleep(0.05)


def _build_parallel(ctx: Context, controller) -> None:
    """``init(parallel=)`` / ``HVD_TPU_PARALLEL``: resolve the spec,
    compare it across ranks and build its role axes (one subgroup per
    axis line, every rank in the same order). A spec that does not
    factor the world disables hybrid parallelism with a warning, as in
    the JAX package."""
    raw = ctx.config.parallel
    if not raw:
        return
    from ..parallel.mesh import build_mesh
    from ..parallel.spec import ParallelSpec

    spec = ParallelSpec.resolve(raw)
    if spec.total != ctx.size:
        logger.warning(
            "parallel spec %r covers %d ranks but the world has %d; "
            "hybrid parallelism disabled", spec.describe(), spec.total,
            ctx.size)
        return
    if controller is not None:
        bad = controller.agree("parallel_spec", spec.describe())
        if bad:
            raise ValueError(
                f"init(): ranks {bad} resolved another parallel spec than "
                f"rank {ctx.rank} ({spec.describe()}); pass the same "
                "parallel= / HVD_TPU_PARALLEL on every rank")
    ctx.parallel_axes = build_mesh(spec, ctx.rank, ctx.size, dist.new_group)
    ctx.axes.update(ctx.parallel_axes)
    ctx.parallel_spec = spec


def _mesh_axes(topo: topo_lib.Topology, cfg, controller) -> tuple:
    """The routing axes of this world (an invalid shape falls back to the
    flat axis with a warning, as in the JAX package). With more than one
    rank every rank's factorization is compared through the store
    first: a rank making other groups would hang the world."""
    try:
        maxes = topo_lib.mesh_axes(
            topo, topo_lib.parse_mesh_shape(cfg.mesh_shape))
    except ValueError as e:
        logger.warning("mesh shape invalid for this world (%s); routing "
                       "falls back to the flat axis", e)
        maxes = topo_lib.mesh_axes(topo, (topo.size,))
    if controller is not None:
        mine = json.dumps([[a.name, a.size] for a in maxes])
        bad = controller.agree("mesh_axes", mine)
        if bad:
            raise ValueError(
                f"init(): ranks {bad} resolved another mesh than rank "
                f"{topo.rank} ({mine}); pass the same mesh_shape / "
                "HVD_TPU_MESH_SHAPE on every rank")
    return maxes


def shutdown() -> None:
    """Synchronize the eager engine's outstanding handles, stop the
    timeline, the stall watchdog and the export surfaces this context
    started (a stopped dump writes its final line), and tear the
    process group down; a later ``init()`` starts afresh."""
    _shutdown(drain=True)


def _shutdown_at_exit() -> None:
    # At interpreter exit nothing waits on the engine's handles: a
    # handle left by a failed step would wait out the process group's
    # timeout.
    _shutdown(drain=False)


def _shutdown(drain: bool) -> None:
    global _context
    with _context_lock:
        ctx = _context
        if ctx is None:
            return
        try:
            for ps in ctx.process_sets:
                ps._engine, ps.axis = None, None
            if drain:
                ctx.engine.drain()
            ctx.timeline.stop()
        finally:
            ctx.stall.stop_watchdog()
            _stop_metrics(ctx)
            dist.destroy_process_group()
            _context = None
            _leave_comm_world()


def _stop_metrics(ctx: Context) -> None:
    from . import metrics as metrics_lib

    if ctx.owns_metrics_dump:
        metrics_lib.stop_file_dump()
    if ctx.owns_metrics_server:
        metrics_lib.stop_serving()


def _leave_comm_world() -> None:
    global _comm_live
    if _comm_live is not None:
        _comm_live.add(_COMM_LIVE_KEY, -1)
        _comm_live = None


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


def cross_rank() -> int:
    """The host index of this rank (``rank // local_size``)."""
    return context().topology.cross_rank


def cross_size() -> int:
    """The number of hosts (``size // local_size``)."""
    return context().topology.cross_size


def is_homogeneous() -> bool:
    """Every host runs ``local_size`` processes."""
    return context().topology.is_homogeneous


# -- capability queries (horovod_tpu/common/basics.py:513-570) ---------------
#
# Reference Horovod answers "what was compiled in" so scripts can pick code
# paths. The port's data plane is torch.distributed, so the answers are
# torch's own build: gloo and MPI as torch.distributed has them, NCCL's
# version from torch.cuda.nccl, CUDA/ROCm from torch.version; DDL, CCL and
# XLA are not part of it. All callable before init().

def mpi_built() -> bool:
    return dist.is_mpi_available()


def mpi_enabled() -> bool:
    """The port never reduces over MPI (its backends are NCCL and gloo)."""
    return False


def mpi_threads_supported() -> bool:
    """Raises, as the reference does when MPI is not enabled."""
    raise ValueError("MPI is not enabled: the port's collectives run over "
                     "torch.distributed's NCCL or gloo backend")


def gloo_built() -> bool:
    return dist.is_gloo_available()


def gloo_enabled() -> bool:
    """True when the live world reduces over gloo."""
    return is_initialized() and context().backend == "gloo"


def nccl_built() -> int:
    """NCCL's version code (major * 10000 + minor * 100 + patch, the
    reference's ``NCCL_VERSION_CODE``), or 0 without NCCL."""
    if not (dist.is_nccl_available() and torch.cuda.is_available()):
        return 0
    major, minor, patch = torch.cuda.nccl.version()[:3]
    return major * 10000 + minor * 100 + patch


def ddl_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def cuda_built() -> bool:
    return torch.version.cuda is not None


def rocm_built() -> bool:
    return getattr(torch.version, "hip", None) is not None


def xla_built() -> bool:
    return False


def tpu_available() -> bool:
    """False: the port's devices are CUDA GPUs (or the CPU), never a
    TPU."""
    return False
