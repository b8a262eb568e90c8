"""The Spark task pool: long-lived Spark tasks as elastic slots — the
port's copy of ``horovod_tpu/spark/task_pool.py`` (Horovod's
``horovod.spark.run_elastic``: ``max_np`` Spark tasks each host a task
service; the elastic driver discovers the registered tasks and starts
worker commands inside them, where Spark scheduled the resources).

Over the rendezvous KV (``runner/rendezvous.py``):

* each Spark task runs :func:`task_service_loop`: register its host,
  heartbeat, poll for an exec request, run at most one worker process
  at a time and publish its exit code;
* :class:`SparkTaskPoolDiscovery` gives the elastic driver the tasks
  whose heartbeat moves (Horovod's SparkDriverHostDiscovery);
* :class:`SparkPoolSpawner` is the driver's epoch spawner
  (``runner.elastic_driver.run_elastic(spawner=)``): each slot becomes
  an exec request on its task, watched through a Popen-like
  :class:`PoolWorkerHandle`.

KV layout (scope ``sparkpool``): ``register/<i>`` hostname, ``hb/<i>``
heartbeat, ``cur_epoch`` the only epoch tasks may run, ``exec/<i>`` the
pending request, ``exit/<i>/<e>`` a worker's exit code, ``kill/<i>/<e>``
a terminate request, ``shutdown`` the pool's stop.
"""

from __future__ import annotations

import json
import os
import re
import signal
import socket
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..runner.elastic_driver import HostDiscovery
from ..runner.launch import _slot_local_env
from ..runner.rendezvous import RendezvousClient

SCOPE = "sparkpool"
HEARTBEAT_S = 1.0
# A task whose heartbeat is older than this is gone (executor lost /
# task killed). Generous vs HEARTBEAT_S so one slow KV round-trip
# doesn't flap the host set (each flap costs a full epoch restart).
STALE_AFTER_S = 6.0
KILL_ESCALATE_S = 10.0


def task_service_loop(index: int, client: RendezvousClient,
                      poll_s: float = 0.25) -> None:
    """Runs INSIDE a Spark task until the pool is shut down (Horovod's
    SparkTaskService): register, heartbeat, execute one worker command
    at a time.

    Each service instance carries a fresh INCARNATION id in every
    heartbeat: a Spark-retried task is a new incarnation, which tells
    the driver that any worker the previous incarnation hosted died with
    it (the retried service itself never re-runs old work — exec
    requests are deleted on pickup)."""
    import uuid

    hostname = socket.gethostname()
    incarnation = uuid.uuid4().hex[:12]
    client.put(SCOPE, f"register/{index}", hostname.encode())
    child: Optional[subprocess.Popen] = None
    child_epoch: Optional[int] = None
    kill_sent_at: Optional[float] = None
    last_hb = 0.0
    beat = 0

    def _reap(rc: int) -> None:
        client.put(SCOPE, f"exit/{index}/{child_epoch}",
                   str(rc).encode())

    while True:
        now = time.time()
        if now - last_hb >= HEARTBEAT_S:
            # Liveness is judged DRIVER-side by the value *changing*
            # (clock skew between hosts must not matter); the beat
            # counter guarantees change even on a frozen clock.
            beat += 1
            client.put(SCOPE, f"hb/{index}",
                       f"{beat}:{incarnation}".encode())
            last_hb = now
        if client.get(SCOPE, "shutdown") is not None:
            if child is not None and child.poll() is None:
                child.terminate()
                try:
                    child.wait(timeout=KILL_ESCALATE_S)
                except subprocess.TimeoutExpired:
                    child.kill()
            return
        if child is not None:
            rc = child.poll()
            if rc is not None:
                _reap(rc)
                child, child_epoch, kill_sent_at = None, None, None
            elif client.get(SCOPE, f"kill/{index}/{child_epoch}") \
                    is not None:
                if kill_sent_at is None:
                    child.terminate()
                    kill_sent_at = now
                elif now - kill_sent_at > KILL_ESCALATE_S:
                    child.kill()
        if child is None:
            raw = client.get(SCOPE, f"exec/{index}")
            if raw is not None:
                # Claim by deletion BEFORE spawning: a Spark-retried
                # task (fresh service on the same index) must never
                # find and re-run this request — a duplicate of a
                # still-live rank would corrupt the epoch.
                client.delete(SCOPE, f"exec/{index}")
                spec = json.loads(raw.decode())
                epoch = int(spec["epoch"])
                cur = client.get(SCOPE, "cur_epoch")
                # Only the driver's CURRENT epoch may run (a request
                # from a dead epoch is dropped; its deletion is the
                # cleanup).
                if cur is not None and int(cur) == epoch:
                    env = dict(os.environ)
                    env.update(spec["env"])
                    child = subprocess.Popen(
                        spec["cmd"], env=env,
                        preexec_fn=_worker_pdeathsig
                        if os.name == "posix" else None)
                    child_epoch = epoch
                    kill_sent_at = None
        time.sleep(poll_s)


def _worker_pdeathsig():
    """Child-side (pre-exec): die with the hosting task service. Spark
    kills lost executors with SIGKILL, which never reaches the child —
    without PR_SET_PDEATHSIG the worker runs on as an orphan (a ghost
    rank completing side effects, or a leaked process parked in a
    collective whose peers are gone)."""
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        PR_SET_PDEATHSIG = 1
        libc.prctl(PR_SET_PDEATHSIG, signal.SIGTERM, 0, 0, 0)
    except Exception:  # noqa: BLE001 — best-effort guard, non-Linux ok
        pass


class _PoolMapper:
    """The ``mapPartitionsWithIndex`` mapper that turns a Spark task
    into a pool slot. A class (not a closure), so plain pickle carries
    it; it holds only the KV's address and secret (executors do not
    share the driver's environment)."""

    def __init__(self, driver_host: str, rdv_port: int, secret: str):
        self.driver_host = driver_host
        self.rdv_port = rdv_port
        self.secret = secret

    def __call__(self, index, _iterator):
        import traceback

        client = RendezvousClient(self.driver_host, self.rdv_port,
                                  timeout_s=30.0,
                                  secret=self.secret.encode())
        try:
            task_service_loop(index, client)
        except BaseException:
            # A crashed service looks like a lost executor to the driver
            # (a stale heartbeat); the KV error key says why.
            try:
                client.put(SCOPE, f"error/{index}",
                           traceback.format_exc().encode())
            except OSError:
                pass
            raise
        yield (index, True)


def make_pool_mapper(driver_host: str, rdv_port: int, secret: str):
    """The mapper of the pool job's tasks."""
    return _PoolMapper(driver_host, rdv_port, secret)


class _HeartbeatTracker:
    """Driver-side liveness from OBSERVED heartbeat changes: a task is
    alive while its hb value keeps changing, judged entirely on the
    driver's monotonic clock — executor/driver wall-clock skew (which a
    timestamp comparison would misread as staleness) cannot matter.
    Thread-safe: the elastic driver's discovery thread and the epoch
    watcher's handles share one tracker."""

    def __init__(self, stale_after_s: float = STALE_AFTER_S):
        self._stale_after_s = stale_after_s
        self._lock = threading.Lock()
        self._seen: Dict[int, Tuple[str, float]] = {}

    def observe(self, index: int, value: Optional[str]) -> bool:
        """Record the current hb value; True iff the task looks alive."""
        now = time.monotonic()
        with self._lock:
            if value is None:
                return False
            prev = self._seen.get(index)
            if prev is None or prev[0] != value:
                self._seen[index] = (value, now)
                return True
            return now - prev[1] <= self._stale_after_s

    def incarnation(self, index: int) -> Optional[str]:
        with self._lock:
            entry = self._seen.get(index)
        if entry is None or ":" not in entry[0]:
            return None
        return entry[0].split(":", 1)[1]


class SparkTaskPoolDiscovery(HostDiscovery):
    """Hosts/slots from the fresh-heartbeat task set (Horovod's
    SparkDriverHostDiscovery).

    Every alive task is its own VIRTUAL host ``<hostname>[<index>]``
    with one slot: failure granularity must be per task, not per
    physical host — a lost Spark task (or one whose worker crashed)
    blacklists only itself, while sibling tasks on the same machine
    keep serving (and keep their stable ranks)."""

    def __init__(self, client: RendezvousClient,
                 stale_after_s: float = STALE_AFTER_S):
        self._client = client
        self.tracker = _HeartbeatTracker(stale_after_s)

    def observe_task(self, index: int) -> bool:
        """One liveness observation of task ``index`` (shared with the
        worker handles)."""
        raw = self._client.get(SCOPE, f"hb/{index}")
        return self.tracker.observe(
            index, raw.decode() if raw is not None else None)

    def alive_tasks(self) -> Dict[str, int]:
        """virtual-host name -> task index, fresh heartbeats only.

        The name embeds the service INCARNATION
        (``host[idx:incarnation]``): a failed worker blacklists only
        that incarnation's name, so when Spark retries the partition
        (same index, fresh incarnation) the replacement appears as a
        NEW virtual host and rejoins — without this, executor churn
        would monotonically shrink the world (each retry inheriting its
        predecessor's blacklist entry)."""
        tasks: Dict[str, int] = {}
        for key in self._client.list(SCOPE):
            if not key.startswith("hb/"):
                continue
            idx = int(key[len("hb/"):])
            if not self.observe_task(idx):
                continue
            inc = self.tracker.incarnation(idx) or "0"
            host_raw = self._client.get(SCOPE, f"register/{idx}")
            if host_raw is None:
                continue
            tasks[f"{host_raw.decode()}[{idx}:{inc}]"] = idx
        return tasks

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        return {vhost: 1 for vhost in self.alive_tasks()}


class PoolWorkerHandle:
    """Popen-like view of a worker running inside a Spark task, backed
    by the KV exit/kill channel. The worker is reported dead (rc=1)
    when the hosting task stops heartbeating — a lost executor must not
    park the epoch forever — OR when the task's incarnation changes: a
    Spark-retried task is a fresh service, so the worker the previous
    incarnation hosted died with it (its renewed heartbeat must not
    mask that)."""

    def __init__(self, discovery: SparkTaskPoolDiscovery,
                 client: RendezvousClient, index: int, epoch: int,
                 incarnation: Optional[str] = None):
        self._discovery = discovery
        self._client = client
        self._index = index
        self._epoch = epoch
        self._incarnation = incarnation
        self._rc: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self._rc is not None:
            return self._rc
        raw = self._client.get(SCOPE,
                               f"exit/{self._index}/{self._epoch}")
        if raw is not None:
            self._rc = int(raw)
            return self._rc
        alive = self._discovery.observe_task(self._index)
        inc = self._discovery.tracker.incarnation(self._index)
        if not alive or (self._incarnation is not None
                         and inc is not None
                         and inc != self._incarnation):
            self._rc = 1
            return self._rc
        return None

    def terminate(self) -> None:
        self._client.put(SCOPE, f"kill/{self._index}/{self._epoch}",
                         b"1")

    def send_signal(self, sig) -> None:
        # The KV channel carries one out-of-band signal: stop. SIGINT on
        # the driver maps to terminating the remote worker.
        if sig in (signal.SIGINT, signal.SIGTERM):
            self.terminate()

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            rc = self.poll()
            if rc is not None:
                return rc
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(
                    f"spark-task-{self._index}", timeout)
            time.sleep(0.1)


class SparkPoolSpawner:
    """``_run_epoch`` spawner over the task pool: maps each SlotInfo to
    an alive task index on its host and publishes the exec request.
    Coordinator negotiation is deferred to the workers (scope
    ``sparkep/<epoch>`` — spark.negotiate_coordinator), because only
    the rank-0 worker knows a free port on ITS host."""

    def __init__(self, client: RendezvousClient,
                 discovery: SparkTaskPoolDiscovery):
        self._client = client
        self._discovery = discovery
        self.epoch = 0
        self.last_world: Optional[int] = None

    _VHOST_RE = re.compile(r"\[(\d+):[0-9a-f]+\]$")

    def __call__(self, slots, command: List[str],
                 env_extra: Dict[str, str]
                 ) -> List[Tuple[str, PoolWorkerHandle]]:
        self.epoch += 1
        self.last_world = len(slots)
        self._client.put(SCOPE, "cur_epoch", str(self.epoch).encode())
        procs: List[Tuple[str, PoolWorkerHandle]] = []
        for s in slots:
            m = self._VHOST_RE.search(s.hostname)
            assert m, f"not a pool virtual host: {s.hostname}"
            index = int(m.group(1))
            env = dict(env_extra)
            env.update(_slot_local_env(s.local_rank, s.local_size))
            env.update({
                "HVD_TPU_NUM_PROC": str(len(slots)),
                "HVD_TPU_PROC_ID": str(s.rank),
                "HVD_TPU_HOSTNAME": s.hostname,
                "HVD_TPU_SPARK_EPOCH": str(self.epoch),
            })
            self._client.put(
                SCOPE, f"exec/{index}",
                json.dumps({"epoch": self.epoch, "cmd": list(command),
                            "env": env}).encode())
            # Pin the hosting service's incarnation at spawn time: if
            # the task is later retried (new incarnation), the handle
            # reports this worker dead instead of waiting forever.
            self._discovery.observe_task(index)
            inc = self._discovery.tracker.incarnation(index)
            procs.append((s.hostname,
                          PoolWorkerHandle(self._discovery,
                                           self._client, index,
                                           self.epoch,
                                           incarnation=inc)))
        return procs
