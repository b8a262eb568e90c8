"""Run a job inside Spark tasks — the port's copy of
``horovod_tpu/spark/__init__.py`` (Horovod's ``horovod.spark.run`` and
``run_elastic``: one Spark task a worker, a driver-side service handing
out addresses, then the regular launch machinery inside the tasks).

Each Spark task becomes one rank of a ``torch.distributed`` world. The
driver runs the rendezvous KV (``runner/rendezvous.py``); task 0
publishes ``<its host>:<free port>`` as ``HVD_TPU_COORDINATOR``, the
TCPStore address the port's ``init()`` meets on; every task reads the
world's layout from the KV, exports the ``HVD_TPU_*`` environment the
launcher would, and calls the user's function, which may ``init()``.
Training over Spark data goes through :mod:`horovod_tpu_torch.estimator`
instead; this module runs a function on the cluster.

pyspark is optional: the module imports without it, and :func:`run`
raises ImportError without it unless ``spark_context=`` is given (the
tests hand in ``testing.fake_spark.FakeSparkContext``). The function
and the mappers travel by cloudpickle where it is installed, else by
pickle (then the function must be importable by name in the tasks).
"""

from __future__ import annotations

import os
import socket
from typing import Any, Dict, Optional, Tuple

from ..runner.launch import _free_port
from ..runner.rendezvous import RendezvousClient, RendezvousServer
from ..runner.task_fn import _pickler

_SCOPE = "spark"


def negotiate_coordinator(client: RendezvousClient, index: int,
                          num_proc: int, hostname: Optional[str] = None,
                          timeout_s: float = 600.0,
                          scope: str = _SCOPE) -> Dict[str, str]:
    """One task's share of the coordinator negotiation over the driver's
    KV (Horovod's SparkTaskService registration): task 0 publishes
    ``<its host>:<free port>`` as the world's coordinator (the TCPStore
    its ``init()`` hosts), every task returns the worker environment
    the launcher would export. ``scope`` keeps negotiations apart (an
    elastic epoch negotiates under ``sparkep/<epoch>``, so a restarted
    world never reads a dead epoch's coordinator)."""
    hostname = hostname or socket.gethostname()
    if index == 0:
        # put_if_absent: a retried task 0 converges on the first
        # address published instead of splitting the world.
        coordinator = client.put_if_absent(
            scope, "coordinator",
            f"{hostname}:{_free_port()}".encode()).decode()
    else:
        raw = client.wait(scope, "coordinator", timeout_s=timeout_s)
        coordinator = raw.decode()
    client.put(scope, f"registered/{index}", hostname.encode())
    return {
        "HVD_TPU_COORDINATOR": coordinator,
        "HVD_TPU_NUM_PROC": str(num_proc),
        "HVD_TPU_PROC_ID": str(index),
        "HVD_TPU_HOSTNAME": hostname,
    }


class _TaskMapper:
    """The partition mapper a Spark task runs: negotiate, export the
    environment, call the function, yield ``(index, result)``. A class
    (not a closure), so plain pickle carries it; the job's KV secret
    travels in it (executors do not share the driver's environment)."""

    def __init__(self, rdv_addr: Tuple[str, int], num_proc: int,
                 payload: bytes, env_extra: Optional[Dict[str, str]],
                 start_timeout: float, secret: Optional[str]):
        self.rdv_addr = rdv_addr
        self.num_proc = num_proc
        self.payload = payload
        self.env_extra = dict(env_extra or {})
        self.start_timeout = start_timeout
        self.secret = secret

    def __call__(self, index, _iterator):
        host, port = self.rdv_addr
        client = RendezvousClient(host, port, timeout_s=30.0,
                                  secret=self.secret.encode()
                                  if self.secret else None)
        env = negotiate_coordinator(client, index, self.num_proc,
                                    timeout_s=self.start_timeout)
        env.update(self.env_extra)
        os.environ.update(env)
        fn, args, kwargs = _pickler().loads(self.payload)
        yield (index, fn(*args, **kwargs))


def _make_mapper(rdv_addr: Tuple[str, int], num_proc: int, fn, args,
                 kwargs, env_extra: Optional[Dict[str, str]],
                 start_timeout: float, secret: Optional[str] = None):
    """The partition mapper of a :func:`run` job."""
    return _TaskMapper(rdv_addr, num_proc,
                       _pickler().dumps((fn, args, kwargs or {})),
                       env_extra, start_timeout, secret)


def _resolve_context(spark_context):
    """The active SparkContext; pyspark is needed only when none is
    given."""
    if spark_context is not None:
        return spark_context
    try:
        import pyspark  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.spark requires pyspark (or an explicit "
            "spark_context); for non-Spark clusters use "
            "horovod_tpu_torch.runner.run / "
            "horovod_tpu_torch.executor.Executor (same per-rank "
            "contract)") from e
    from pyspark.sql import SparkSession

    session = SparkSession.getActiveSession()
    if session is None:
        raise RuntimeError("no active SparkSession and no "
                           "spark_context given")
    return session.sparkContext


_drop_in_warned = False


def _absorb_drop_in_knobs(caller: str, **knobs) -> None:
    """Accept Horovod's extra ``run``/``run_elastic`` knobs, so
    ``import horovod_tpu_torch.spark as spark`` is call-compatible.
    ``verbose >= 2`` lowers the package's log level to DEBUG; a transport
    or stream knob the caller set is warned about once a process (the
    data plane is the process group ``init()`` makes; worker output goes
    to the Spark task logs)."""
    import logging as _logging

    verbose = knobs.pop("verbose", None)
    if verbose is not None and verbose >= 2:
        _logging.getLogger("horovod_tpu_torch").setLevel(_logging.DEBUG)
    # None, () and False are Horovod's own "unset" defaults.
    ignored = {k: v for k, v in knobs.items()
               if v not in (None, (), False)}
    if ignored:
        global _drop_in_warned
        if not _drop_in_warned:
            _drop_in_warned = True
            import warnings

            warnings.warn(
                f"{caller}: ignoring Horovod knobs that have no meaning "
                f"here: {sorted(ignored)} (the data plane is the process "
                "group init() makes: no MPI/gloo launcher choice, no NIC "
                "selection; worker stdout/stderr go to the Spark task "
                "logs)", UserWarning, stacklevel=3)


def run(fn, args=(), kwargs=None, num_proc: Optional[int] = None, *,
        spark_context=None, env: Optional[Dict[str, str]] = None,
        start_timeout: float = 600.0, use_mpi=None, use_gloo=None,
        extra_mpi_args=None, stdout=None, stderr=None, verbose=1,
        nics=None, prefix_output_with_timestamp=False):
    """Run ``fn`` as ``num_proc`` workers inside Spark tasks; returns the
    results in rank order (Horovod's ``horovod.spark.run``). Everything
    after ``num_proc`` is keyword-only: Horovod's fifth positional is
    ``start_timeout``, so a positional call in its order fails
    (TypeError) instead of binding wrongly. The compatibility knobs are
    absorbed (:func:`_absorb_drop_in_knobs`)."""
    _absorb_drop_in_knobs(
        "horovod_tpu_torch.spark.run", verbose=verbose, use_mpi=use_mpi,
        use_gloo=use_gloo, extra_mpi_args=extra_mpi_args, stdout=stdout,
        stderr=stderr, nics=nics,
        prefix_output_with_timestamp=prefix_output_with_timestamp)
    spark_context = _resolve_context(spark_context)
    if num_proc is None:
        num_proc = spark_context.defaultParallelism

    import secrets as _secrets
    import threading
    import time

    # The driver's KV, at the address executors reach (spark.driver.host).
    driver_host = spark_context.getConf().get("spark.driver.host",
                                              socket.gethostname())
    job_secret = _secrets.token_hex(16)
    rdv = RendezvousServer("0.0.0.0", secret=job_secret.encode())
    rdv_port = rdv.start()
    job_group = "horovod_tpu_torch.spark"
    holder: Dict[str, Any] = {}
    try:
        mapper = _make_mapper((driver_host, rdv_port), num_proc, fn,
                              args, kwargs, env, start_timeout,
                              secret=job_secret)
        rdd = spark_context.parallelize(range(num_proc),
                                        numSlices=num_proc)

        def collect_job():
            try:
                spark_context.setJobGroup(job_group,
                                          "horovod_tpu_torch run",
                                          interruptOnCancel=True)
                holder["results"] = rdd.mapPartitionsWithIndex(
                    mapper).collect()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                holder["error"] = e

        t = threading.Thread(target=collect_job, daemon=True)
        t.start()
        # The registration barrier (Horovod's start_timeout): a cluster
        # that cannot run num_proc tasks at once would leave the
        # scheduled ones waiting in init() forever.
        deadline = time.monotonic() + start_timeout
        while t.is_alive():
            t.join(timeout=1.0)
            if not t.is_alive():
                break
            registered = sum(
                1 for i in range(num_proc)
                if rdv.get(_SCOPE, f"registered/{i}") is not None)
            if registered < num_proc and time.monotonic() > deadline:
                spark_context.cancelJobGroup(job_group)
                raise TimeoutError(
                    f"only {registered}/{num_proc} Spark tasks "
                    f"registered within {start_timeout}s — the cluster "
                    "cannot co-schedule the requested world (shrink "
                    "num_proc or grow the executor pool)")
        if "error" in holder:
            raise holder["error"]
        return [r for _, r in sorted(holder["results"])]
    finally:
        rdv.stop()


def run_elastic(fn, args=(), kwargs=None, num_proc: Optional[int] = None,
                min_np: Optional[int] = None,
                max_np: Optional[int] = None,
                start_timeout: float = 600.0,
                elastic_timeout: float = 600.0,
                reset_limit: Optional[int] = None,
                env: Optional[Dict[str, str]] = None, *,
                spark_context=None, verbose=1, nics=None):
    """Run ``fn`` elastically inside Spark tasks (Horovod's
    ``horovod.spark.run_elastic``): ``max_np`` long-lived tasks form a
    pool, the elastic driver (``runner/elastic_driver.py``) discovers
    the live ones, starts a worker inside each and rescales between
    ``min_np`` and ``max_np`` as tasks come and go. ``fn`` keeps its own
    state through ``hvd.elastic.run``. Returns the final world's results
    in rank order. Discovery and the spawner both ride the driver's
    rendezvous KV, which the executors reach at ``spark.driver.host``."""
    _absorb_drop_in_knobs("horovod_tpu_torch.spark.run_elastic",
                          verbose=verbose, nics=nics)
    import argparse
    import pickle
    import secrets as _secrets
    import sys
    import threading
    import time

    from ..runner.elastic_driver import run_elastic as _run_elastic
    from .elastic_worker import RESULT_SCOPE
    from .task_pool import (SCOPE as POOL_SCOPE, SparkPoolSpawner,
                            SparkTaskPoolDiscovery, make_pool_mapper)

    spark_context = _resolve_context(spark_context)
    if num_proc is None:
        num_proc = spark_context.defaultParallelism
    min_np = min_np or num_proc
    max_np = max_np or num_proc

    driver_host = spark_context.getConf().get("spark.driver.host",
                                              socket.gethostname())
    job_secret = _secrets.token_hex(16)
    rdv = RendezvousServer("0.0.0.0", secret=job_secret.encode())
    rdv_port = rdv.start()
    client = RendezvousClient("127.0.0.1", rdv_port, timeout_s=30.0,
                              secret=job_secret.encode())
    job_group = "horovod_tpu_torch.spark.elastic"
    pool_holder: Dict[str, Any] = {}
    pool_thread: Optional[Any] = None

    def pool_job():
        try:
            spark_context.setJobGroup(job_group,
                                      "horovod_tpu_torch elastic pool",
                                      interruptOnCancel=True)
            mapper = make_pool_mapper(driver_host, rdv_port, job_secret)
            pool_holder["done"] = spark_context.parallelize(
                range(max_np), numSlices=max_np) \
                .mapPartitionsWithIndex(mapper).collect()
        except BaseException as e:  # noqa: BLE001 — surfaced below
            # A lost task fails collect() on some backends: the elastic
            # driver's business (discovery sees the stale heartbeat).
            pool_holder["error"] = e

    try:
        client.put(POOL_SCOPE, "fn", _pickler().dumps((fn, args,
                                                       kwargs or {})))
        pool_thread = threading.Thread(target=pool_job, daemon=True)
        pool_thread.start()

        class _PoolDiscovery(SparkTaskPoolDiscovery):
            # The whole pool dying fails the run at once with Spark's
            # cause instead of waiting elastic_timeout for slots.
            def find_available_hosts_and_slots(self):
                hosts = super().find_available_hosts_and_slots()
                if not hosts and "error" in pool_holder:
                    raise RuntimeError(
                        "Spark pool job failed while the elastic run "
                        "was waiting for tasks") from pool_holder["error"]
                return hosts

        # The initial registration barrier: num_proc tasks within
        # start_timeout (it also makes the first world's size certain).
        discovery = _PoolDiscovery(client)
        deadline = time.monotonic() + start_timeout
        while True:
            alive = sum(
                discovery.find_available_hosts_and_slots().values())
            if alive >= num_proc:
                break
            if "error" in pool_holder:
                raise pool_holder["error"]
            if time.monotonic() > deadline:
                spark_context.cancelJobGroup(job_group)
                raise TimeoutError(
                    f"only {alive}/{num_proc} Spark pool tasks "
                    f"registered within {start_timeout}s — the cluster "
                    "cannot co-schedule the requested world (shrink "
                    "num_proc or grow the executor pool)")
            time.sleep(0.25)

        spawner = SparkPoolSpawner(client, discovery)
        ns = argparse.Namespace(
            num_proc=num_proc, min_np=min_np, max_np=max_np,
            host_discovery_script=None, hosts=None, ssh_port=None)
        rc = _run_elastic(
            ns,
            [sys.executable, "-m",
             "horovod_tpu_torch.spark.elastic_worker"],
            env_extra=dict(env or {}),
            discovery=discovery,
            reset_limit=reset_limit,
            slot_wait_timeout_s=elastic_timeout,
            spawner=spawner,
            rdv_server=rdv,
            rdv_advertise=f"{driver_host}:{rdv_port}",
            rdv_secret=job_secret)
        if rc != 0:
            crashes = []
            for key in client.list(POOL_SCOPE):
                if key.startswith("error/"):
                    raw = client.get(POOL_SCOPE, key) or b""
                    crashes.append(f"task {key[len('error/'):]}:\n"
                                   f"{raw.decode(errors='replace')}")
            detail = ("\n".join(crashes) if crashes
                      else "(no task service crash reports)")
            raise RuntimeError(
                f"elastic Spark run failed with exit code {rc}; "
                f"{detail}") from pool_holder.get("error")

        # The final epoch's results (an aborted epoch's values are keyed
        # by their own epoch and never mix in).
        results = []
        for rank in range(spawner.last_world or 0):
            raw = client.wait(RESULT_SCOPE,
                              f"{spawner.epoch}/{rank}", timeout_s=30.0)
            results.append(pickle.loads(raw))
        return results
    finally:
        try:
            client.put(POOL_SCOPE, "shutdown", b"1")
        except OSError:
            pass
        if pool_thread is not None:
            pool_thread.join(timeout=30.0)
            if pool_thread.is_alive():
                spark_context.cancelJobGroup(job_group)
        rdv.stop()
