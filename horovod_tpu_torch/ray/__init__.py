"""Ray cluster integration — the port's copy of
``horovod_tpu/ray/__init__.py`` (Horovod's ``horovod.ray``:
``BaseHorovodWorker``, ``Coordinator``, ``RayExecutor``,
``ElasticRayExecutor``, ``RayHostDiscovery``).

Workers join one ``torch.distributed`` world from the environment the
``Coordinator`` derives from their registered hostnames (the launcher's
bootstrap), so colocation comes down to grouping hostnames into local
ranks; Horovod's ``NodeColocator`` actors and placement groups have
nothing to do here. Several actors on one card need
``init(backend="gloo")`` in the function they run.

``ray`` is imported at call time: the module imports without it, and
tests and ``chip_smoke.py`` put ``testing.fake_ray`` in
``sys.modules["ray"]``. Each worker sets its slot environment first and
initializes the runtime in the user's function after, as a
launcher-started slot does.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


def _ray():
    import ray

    return ray


# -- settings (Horovod's ray/runner.py) ------------------

@dataclass
class MiniSettings:
    """Start and placement knobs (Horovod's MiniSettings)."""

    timeout_s: int = 300
    placement_group_timeout_s: int = 100
    extra_env: Dict[str, str] = field(default_factory=dict)

    @property
    def start_timeout(self) -> int:
        return self.timeout_s


# -- worker actor (Horovod's ray/runner.py) ---------

class BaseHorovodWorker:
    """Runs inside a Ray actor process (Horovod's worker): report the
    hostname, take environment updates, run functions. The user's
    function calls ``hvd.init()`` after the environment arrived, so the
    world's bootstrap sees the slot's environment."""

    def __init__(self, world_rank: int = 0, world_size: int = 1):
        self.world_rank = world_rank
        self.world_size = world_size
        self.executable: Any = None

    def hostname(self) -> str:
        return socket.gethostname()

    def free_port(self) -> int:
        """A free port on this host: rank 0's ``init()`` hosts the
        world's TCPStore in its own process, so the port must be free
        where rank 0 lives, not on the driver's machine."""
        s = socket.socket()
        s.bind(("", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    def update_env_vars(self, env_vars: Dict[str, str]) -> None:
        """Apply before the runtime is initialized in this process."""
        os.environ.update({k: str(v) for k, v in env_vars.items()})

    def env_vars(self) -> Dict[str, str]:
        return dict(os.environ)

    def start_executable(self, executable_cls: Optional[type] = None,
                         executable_args: Optional[list] = None,
                         executable_kwargs: Optional[dict] = None) -> None:
        """Instantiate the user's class inside the worker, after the
        environment arrived (its ``__init__`` may call ``init()``)."""
        if executable_cls is not None:
            self.executable = executable_cls(*(executable_args or []),
                                             **(executable_kwargs or {}))

    def execute(self, fn: Callable) -> Any:
        """``fn(executable)`` (Horovod's worker execute contract)."""
        return fn(self.executable)

    def shutdown_engine(self) -> None:
        import horovod_tpu_torch as hvd

        if hvd.is_initialized():
            hvd.shutdown()


# -- coordinator (Horovod's ray/runner.py) --------------------------

class Coordinator:
    """Collects (hostname, world_rank) registrations and derives each
    worker's slot environment: global, local and cross ranks and the
    coordinator address (rank 0's host and port: the TCPStore its
    ``init()`` hosts), as Horovod's ``establish_rendezvous`` does."""

    def __init__(self, settings: Optional[MiniSettings] = None):
        self.settings = settings or MiniSettings()
        self.hostnames_by_rank: Dict[int, str] = {}
        self.coordinator_port: Optional[int] = None

    @property
    def world_size(self) -> int:
        return len(self.hostnames_by_rank)

    @property
    def hoststring(self) -> str:
        hosts: Dict[str, List[int]] = {}
        for rank in sorted(self.hostnames_by_rank):
            hosts.setdefault(self.hostnames_by_rank[rank], []).append(rank)
        return ",".join(f"{h}:{len(r)}" for h, r in hosts.items())

    def register(self, hostname: str, world_rank: int) -> None:
        self.hostnames_by_rank[world_rank] = hostname

    def finalize_registration(self) -> Dict[int, Dict[str, str]]:
        """Each rank's environment: the ``HVD_TPU_*`` bootstrap that
        ``init()`` and the topology read."""
        by_host: Dict[str, List[int]] = {}
        for rank in sorted(self.hostnames_by_rank):
            by_host.setdefault(self.hostnames_by_rank[rank], []).append(rank)

        rank0_host = self.hostnames_by_rank.get(0, "127.0.0.1")
        if self.coordinator_port is None:
            # A probe on the calling machine: a caller that reaches rank
            # 0's host (RayExecutor.start, through the worker's
            # free_port()) sets coordinator_port first, since a port
            # free here may be taken there.
            s = socket.socket()
            s.bind(("", 0))
            self.coordinator_port = s.getsockname()[1]
            s.close()
        coordinator = f"{rank0_host}:{self.coordinator_port}"

        envs: Dict[int, Dict[str, str]] = {}
        for host, ranks in by_host.items():
            for local_rank, rank in enumerate(ranks):
                envs[rank] = {
                    "HVD_TPU_COORDINATOR": coordinator,
                    "HVD_TPU_NUM_PROC": str(self.world_size),
                    "HVD_TPU_PROC_ID": str(rank),
                    "HVD_TPU_LOCAL_RANK": str(local_rank),
                    "HVD_TPU_LOCAL_SIZE": str(len(ranks)),
                    "HVD_TPU_CROSS_RANK":
                        str(sorted(by_host).index(host)),
                    "HVD_TPU_CROSS_SIZE": str(len(by_host)),
                    **self.settings.extra_env,
                }
        return envs


# -- executor (Horovod's ray/runner.py) -----------------------------

class RayExecutor:
    """Persistent Horovod worker pool on Ray actors.

    Horovod's RayExecutor surface: ``create_settings``,
    ``start(executable_cls=...)``, ``run``, ``run_remote``, ``execute``,
    ``execute_single``, ``shutdown``, ``num_workers``.

    Example::

        ray.init(address="auto")
        ex = RayExecutor(RayExecutor.create_settings(300), num_workers=4)
        ex.start()
        ex.run(train_fn)          # fn may hvd.init(), run collectives
        ex.shutdown()
    """

    @classmethod
    def create_settings(cls, timeout_s: int = 300,
                        ssh_identity_file: Optional[str] = None,
                        ssh_str: Optional[str] = None) -> MiniSettings:
        # ssh args accepted for signature parity; Ray actors need no ssh.
        return MiniSettings(timeout_s=timeout_s)

    def __init__(self, settings: Optional[MiniSettings] = None,
                 num_workers: int = 1, cpus_per_worker: int = 1,
                 use_gpu: bool = False, gpus_per_worker: int = 0,
                 env: Optional[Dict[str, str]] = None):
        self.settings = settings or MiniSettings()
        self._num_workers = int(num_workers)
        self.cpus_per_worker = cpus_per_worker
        self.use_gpu = use_gpu          # asks Ray for gpus_per_worker
        self.gpus_per_worker = gpus_per_worker
        self.env = dict(env or {})
        self.workers: List[Any] = []
        self.coordinator = Coordinator(self.settings)
        self._started = False

    @property
    def num_workers(self) -> int:
        return self._num_workers

    def start(self,
              executable_cls: Optional[type] = None,
              executable_args: Optional[list] = None,
              executable_kwargs: Optional[dict] = None,
              extra_env_vars: Optional[Dict[str, str]] = None) -> None:
        """Create the actors, run the registration round, push each
        worker its slot environment, then instantiate ``executable_cls``
        inside each worker (Horovod's start(): create_workers,
        Coordinator registration, establish_rendezvous, update_env_vars,
        start_executable)."""
        ray = _ray()
        remote_cls = ray.remote(BaseHorovodWorker)
        opts: Dict[str, Any] = {"num_cpus": self.cpus_per_worker}
        if self.use_gpu and self.gpus_per_worker:
            opts["num_gpus"] = self.gpus_per_worker
        remote_cls = remote_cls.options(**opts)
        self.workers = [
            remote_cls.remote(world_rank=rank,
                              world_size=self._num_workers)
            for rank in range(self._num_workers)]

        hostnames = ray.get([w.hostname.remote() for w in self.workers])
        for rank, hostname in enumerate(hostnames):
            self.coordinator.register(hostname, rank)
        # The coordinator's port, probed on rank 0's host (its TCPStore
        # binds inside rank 0's actor process).
        self.coordinator.coordinator_port = ray.get(
            self.workers[0].free_port.remote())
        envs = self.coordinator.finalize_registration()

        base = {**self.env, **(extra_env_vars or {})}
        ray.get([
            w.update_env_vars.remote({**base, **envs[rank]})
            for rank, w in enumerate(self.workers)])
        if executable_cls is not None:
            ray.get([w.start_executable.remote(
                        executable_cls, executable_args,
                        executable_kwargs)
                     for w in self.workers])
        self._started = True

    def run_remote(self, fn: Callable, args: Optional[list] = None,
                   kwargs: Optional[dict] = None) -> List[Any]:
        """Dispatch without blocking; returns the object refs."""
        if not self._started:
            raise RuntimeError("RayExecutor not started — call start()")
        call = _IgnoreExecutable(fn, tuple(args or ()), kwargs or {})
        return [w.execute.remote(call) for w in self.workers]

    def run(self, fn: Callable, args: Optional[list] = None,
            kwargs: Optional[dict] = None) -> List[Any]:
        """Run ``fn`` on every worker; the results in rank order."""
        return _ray().get(self.run_remote(fn, args, kwargs))

    def execute(self, fn: Callable[[Any], Any]) -> List[Any]:
        """Apply ``fn(executable)`` on every worker (for
        ``executable_cls`` users)."""
        if not self._started:
            raise RuntimeError("RayExecutor not started — call start()")
        return _ray().get([w.execute.remote(fn) for w in self.workers])

    def execute_single(self, fn: Callable, args: Optional[list] = None,
                       kwargs: Optional[dict] = None, rank: int = 0
                       ) -> Any:
        """One worker only; fn must not issue collectives."""
        if not self._started:
            raise RuntimeError("RayExecutor not started — call start()")
        call = _IgnoreExecutable(fn, tuple(args or ()), kwargs or {})
        return _ray().get(self.workers[rank].execute.remote(call))

    def shutdown(self) -> None:
        ray = _ray()
        if self.workers:
            try:
                ray.get([w.shutdown_engine.remote()
                         for w in self.workers],
                        timeout=self.settings.timeout_s)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
            for w in self.workers:
                ray.kill(w)
        self.workers = []
        self._started = False


class _IgnoreExecutable:
    """Picklable bridge for run()/execute_single(): the worker's
    execute(fn) channel passes the executable, which plain functions
    don't take — swallow it and call fn(*args, **kwargs)."""

    def __init__(self, fn: Callable, args: tuple, kwargs: dict):
        self._fn, self._args, self._kwargs = fn, args, kwargs

    def __call__(self, _executable) -> Any:
        return self._fn(*self._args, **self._kwargs)


# -- elastic (Horovod's ray/elastic.py) -------------------------------------

@dataclass
class ElasticSettings:
    """What ``ElasticRayExecutor.create_settings`` makes.

    ``elastic_timeout``: seconds to wait for >= min_np slots before the
    job fails. ``timeout_s``: worker graceful-exit window on a topology
    change (seconds between the interrupt being published and workers
    being terminated). ``max_np=None`` means uncapped: the job grows to
    whatever the cluster offers."""

    min_np: int = 1
    max_np: Optional[int] = None
    reset_limit: Optional[int] = None
    elastic_timeout: int = 600
    # None = fall through to the HVD_TPU_ELASTIC_GRACE_SECS env knob
    # (default 30) — an explicit value here overrides it.
    timeout_s: Optional[int] = None
    extra_env: Dict[str, str] = field(default_factory=dict)


class ElasticRayExecutor:
    """Elastic jobs with hosts and slots discovered from the live Ray
    cluster's state (Horovod's ElasticRayExecutor), on the port's
    elastic driver (``runner/elastic_driver.py``: rank-stable
    assignments, the blacklist, the topology-version channel) with
    :class:`RayHostDiscovery` as the source: nodes joining or leaving
    the Ray cluster grow or shrink the job between commits.

    Example::

        ray.init(address="auto")
        settings = ElasticRayExecutor.create_settings(min_np=1)
        executor = ElasticRayExecutor(settings, cpus_per_slot=2)
        executor.start()
        results = executor.run(train_fn)   # fn uses @hvd.elastic.run
    """

    @staticmethod
    def create_settings(min_np: int = 1, max_np: Optional[int] = None,
                        reset_limit: Optional[int] = None,
                        elastic_timeout: int = 600,
                        timeout_s: Optional[int] = None,
                        extra_env: Optional[Dict[str, str]] = None
                        ) -> ElasticSettings:
        """No ``**kwargs``: a mistyped setting raises instead of being
        dropped."""
        return ElasticSettings(min_np=min_np, max_np=max_np,
                               reset_limit=reset_limit,
                               elastic_timeout=elastic_timeout,
                               timeout_s=timeout_s,
                               extra_env=dict(extra_env or {}))

    def __init__(self, settings: Optional[ElasticSettings] = None,
                 use_gpu: bool = False, cpus_per_slot: int = 1,
                 gpus_per_slot: int = 1,
                 env_vars: Optional[Dict[str, str]] = None,
                 override_discovery: bool = True):
        self.settings = settings or ElasticSettings()
        self.env_vars = dict(env_vars or {})
        self.discovery: Optional["RayHostDiscovery"] = None
        if override_discovery:
            self.discovery = RayHostDiscovery(
                use_gpu=use_gpu, cpus_per_slot=cpus_per_slot,
                gpus_per_slot=gpus_per_slot)

    def start(self) -> None:
        """Validate the cluster serves at least min_np slots."""
        if self.discovery is None:
            raise RuntimeError("no discovery source; construct with "
                               "override_discovery=True or set "
                               ".discovery")
        hosts = self.discovery.find_available_hosts_and_slots()
        if sum(hosts.values()) < self.settings.min_np:
            raise RuntimeError(
                f"Ray cluster offers {sum(hosts.values())} slots < "
                f"min_np={self.settings.min_np}")

    def run(self, worker_fn: Callable) -> List[Any]:
        """Run ``worker_fn`` elastically; returns the final world's
        values in rank order (the function keeps its own elastic state
        through ``hvd.elastic.run``). It travels by cloudpickle where it
        is installed, else by pickle."""
        import argparse
        import sys
        import tempfile

        from ..runner.elastic_driver import run_elastic
        from ..runner.task_fn import _pickler

        if self.discovery is None:
            raise RuntimeError("no discovery source; construct with "
                               "override_discovery=True or set "
                               ".discovery")
        with tempfile.TemporaryDirectory(prefix="hvd_ray_elastic_") \
                as tmp:
            fn_path = os.path.join(tmp, "fn.pkl")
            results_dir = os.path.join(tmp, "results")
            with open(fn_path, "wb") as f:
                _pickler().dump(worker_fn, f)

            hosts = self.discovery.find_available_hosts_and_slots()
            np_now = min(sum(hosts.values()),
                         self.settings.max_np or sum(hosts.values()))
            # max_np=None means uncapped: run_elastic folds None to
            # num_proc, which would freeze the job at today's cluster
            # size — pass an effectively-infinite cap instead so new
            # nodes grow the world.
            args = argparse.Namespace(
                num_proc=np_now, min_np=self.settings.min_np,
                max_np=self.settings.max_np or 2 ** 30,
                host_discovery_script=None, hosts=None, ssh_port=None)
            rc = run_elastic(
                args,
                [sys.executable, "-m",
                 "horovod_tpu_torch.ray.elastic_worker",
                 fn_path, results_dir],
                env_extra={**self.settings.extra_env, **self.env_vars},
                discovery=self.discovery,
                reset_limit=self.settings.reset_limit,
                slot_wait_timeout_s=self.settings.elastic_timeout,
                grace_secs=self.settings.timeout_s)
            if rc != 0:
                raise RuntimeError(
                    f"elastic run failed with exit code {rc}")
            return self._collect_results(results_dir)

    @staticmethod
    def _collect_results(results_dir: str) -> List[Any]:
        """Keep only the FINAL topology's values: files are named
        rank_{rank}_of_{np}; an aborted epoch's leftovers (different
        world size, or a rank >= the final size) must not mix in. The
        final epoch is identified by the newest file's world size."""
        import pickle

        if not os.path.isdir(results_dir):
            return []
        entries = []  # (mtime, rank, np, path)
        for name in os.listdir(results_dir):
            if not (name.startswith("rank_") and name.endswith(".pkl")):
                continue
            try:
                rank_s, np_s = name[len("rank_"):-len(".pkl")] \
                    .split("_of_")
                rank, world = int(rank_s), int(np_s)
            except ValueError:
                continue
            path = os.path.join(results_dir, name)
            entries.append((os.path.getmtime(path), rank, world, path))
        if not entries:
            return []
        final_world = max(entries)[2]
        by_rank = {}
        for _, rank, world, path in sorted(entries):
            if world == final_world and rank < world:
                by_rank[rank] = path  # later mtime wins per rank
        results = []
        for rank in sorted(by_rank):
            with open(by_rank[rank], "rb") as f:
                results.append(pickle.load(f))
        return results


# -- elastic discovery (Horovod's ray/elastic.py) ---------------------

class RayHostDiscovery:
    """Feeds the elastic driver from the live Ray cluster's state: every
    alive node with CPU (or, with ``use_gpu``, GPU) resources gives its
    worker slots."""

    def __init__(self, use_gpu: bool = False, cpus_per_slot: int = 1,
                 gpus_per_slot: int = 1):
        self.use_gpu = use_gpu
        self.cpus_per_slot = cpus_per_slot
        self.gpus_per_slot = gpus_per_slot

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        ray = _ray()
        hosts: Dict[str, int] = {}
        for node in ray.nodes():
            if not node.get("Alive", False):
                continue
            resources = node.get("Resources", {})
            hostname = node.get("NodeManagerHostname") \
                or node.get("NodeManagerAddress", "unknown")
            if self.use_gpu:
                slots = int(resources.get("GPU", 0) // self.gpus_per_slot)
            else:
                slots = int(resources.get("CPU", 0) // self.cpus_per_slot)
            if slots > 0:
                hosts[hostname] = slots
        return hosts
