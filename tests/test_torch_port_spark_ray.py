"""The port's Spark and Ray adapters against the JAX package's
(``test_spark.py``, ``test_spark_elastic.py``, ``test_ray.py``), on the
port's process-backed fakes (``horovod_tpu_torch.testing``).

* Protocol pieces run in this process on both packages with the same
  inputs and are compared exactly: the coordinator negotiation and the
  task mapper against a rendezvous KV, the heartbeat tracker and the
  pool handle's view of a retried task, the drop-in knobs' signatures,
  the Ray ``Coordinator``'s host string and environments,
  ``RayHostDiscovery`` over the same ``ray.nodes()``, and the elastic
  executor's collection of the final world's results.
* The process-backed cases mirror the JAX tests on the port alone: real
  task and actor processes (the spawn context), real gloo worlds on the
  CPU (``init(device="cpu")``), real elastic epochs. Where a world
  reduces, the result is checked bitwise against the same reduction by
  hand. Every such case holds the session's world slot.

The functions the tasks, actors and elastic workers run are this file's
module-level functions: the processes import it by name.
"""

from __future__ import annotations

import inspect
import os
import sys
import threading
import time

import pytest
import torch

import horovod_tpu_torch.spark as hvd_spark
from horovod_tpu_torch.runner.rendezvous import RendezvousServer
from horovod_tpu_torch.testing import fake_ray
from horovod_tpu_torch.testing.fake_spark import FakeSparkContext
from test_torch_port_worlds import REPO, world_slot

# Workers and tasks import this file (and the repo) by name.
PYPATH = os.pathsep.join([str(REPO / "tests"), str(REPO)]
                         + [p for p in [os.environ.get("PYTHONPATH")] if p])
WORKER_ENV = {"PYTHONPATH": PYPATH, "OMP_NUM_THREADS": "1"}
PRE, POST = 1 / 3, 1.5


@pytest.fixture(autouse=True, scope="module")
def _task_path():
    # Spawned tasks and actors take this process's sys.path; the elastic
    # workers take the environment.
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = PYPATH
    yield
    if old is None:
        os.environ.pop("PYTHONPATH", None)
    else:
        os.environ["PYTHONPATH"] = old


def _children_of(pid):
    try:
        with open(f"/proc/{pid}/task/{pid}/children") as f:
            return [int(x) for x in f.read().split()]
    except (OSError, ValueError):
        return []


# -- functions the tasks, actors and workers run -----------------------------

def _probe_fn(tag):
    return (tag, int(os.environ["HVD_TPU_PROC_ID"]),
            int(os.environ["HVD_TPU_NUM_PROC"]),
            os.environ["HVD_TPU_COORDINATOR"])


def _rank_input(rank: int):
    g = torch.Generator().manual_seed(900 + rank)
    return torch.randn(33, generator=g).to(torch.bfloat16)


def _hand_allreduce(n: int):
    """Sum of every rank's input, each prescaled and the sum postscaled,
    every step rounded to bf16 (the scales rounded to bf16 first)."""
    pre = torch.tensor(PRE, dtype=torch.bfloat16)
    post = torch.tensor(POST, dtype=torch.bfloat16)
    acc = _rank_input(0) * pre
    for r in range(1, n):
        acc = acc + _rank_input(r) * pre
    return acc * post


def _allreduce_fn():
    """init() on the CPU, a bf16 allreduce with pre- and postscale."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        out = hvd.allreduce(_rank_input(hvd.rank()), op=hvd.Sum,
                            name="cluster.scaled", prescale_factor=PRE,
                            postscale_factor=POST)
        return hvd.rank(), hvd.size(), out.view(torch.int16).tolist()
    finally:
        hvd.shutdown()


def _init_default_fn():
    """init() with no device: the GPU, which this machine lacks."""
    import horovod_tpu_torch as hvd

    hvd.init()


def _parked_until_shrunk_fn():
    world = int(os.environ["HVD_TPU_NUM_PROC"])
    if world >= 3:
        time.sleep(600)
        return ("never", -1, world)
    return ("resumed", int(os.environ["HVD_TPU_PROC_ID"]), world)


def _parked_until_grown_fn():
    world = int(os.environ["HVD_TPU_NUM_PROC"])
    if world <= 2:
        time.sleep(600)
        return ("never", -1, world)
    return ("grown", int(os.environ["HVD_TPU_PROC_ID"]), world)


# -- Spark: the protocol pieces ----------------------------------------------

def _negotiate(mod_rdv, negotiate, n=3):
    srv = mod_rdv.RendezvousServer("127.0.0.1")
    port = srv.start()
    results = {}
    try:
        def task(index):
            client = mod_rdv.RendezvousClient("127.0.0.1", port)
            results[index] = negotiate(client, index, n,
                                       hostname=f"exec{index}",
                                       timeout_s=10.0)

        threads = [threading.Thread(target=task, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=15)
        registered = [srv.get("spark", f"registered/{i}") for i in range(n)]
    finally:
        srv.stop()
    return results, registered


def test_negotiate_coordinator_matches_jax():
    """Task 0 publishes ``exec0:<port>``; every task returns the same
    environment as the JAX negotiation (the port number aside)."""
    from horovod_tpu.runner import rendezvous as jrdv
    from horovod_tpu.spark import negotiate_coordinator as jnegotiate
    from horovod_tpu_torch.runner import rendezvous as prdv

    got, got_reg = _negotiate(prdv, hvd_spark.negotiate_coordinator)
    want, want_reg = _negotiate(jrdv, jnegotiate)
    coord = got[0]["HVD_TPU_COORDINATOR"]
    assert coord.startswith("exec0:")
    for i in range(3):
        assert got[i]["HVD_TPU_COORDINATOR"] == coord
        a = dict(got[i], HVD_TPU_COORDINATOR="")
        b = dict(want[i], HVD_TPU_COORDINATOR="")
        assert a == b
    assert got_reg == want_reg == [b"exec0", b"exec1", b"exec2"]


def test_mapper_wires_env_and_runs_fn():
    """The task mapper: negotiated environment exported, ``fn`` called,
    ``(index, result)`` yielded; plain pickle carries it."""
    import pickle

    def probe(a, b=0):
        return (int(os.environ["HVD_TPU_PROC_ID"]),
                os.environ["HVD_TPU_COORDINATOR"], a + b)

    srv = RendezvousServer("127.0.0.1")
    port = srv.start()
    saved = dict(os.environ)
    try:
        mapper = hvd_spark._make_mapper(("127.0.0.1", port), 2, probe, (1,),
                                        {"b": 41}, {"HVD_TPU_EXTRA": "x"},
                                        start_timeout=10.0)
        out = {i: list(mapper(i, iter([])))[0] for i in (0, 1)}
        assert out[0][0] == 0 and out[1][0] == 1
        (i0, coord0, val0), (i1, coord1, val1) = out[0][1], out[1][1]
        assert (i0, i1) == (0, 1) and coord0 == coord1
        assert val0 == val1 == 42
        assert os.environ.get("HVD_TPU_EXTRA") == "x"
        pickle.loads(pickle.dumps(hvd_spark._make_mapper(
            ("127.0.0.1", port), 2, _probe_fn, ("t",), None, None, 1.0)))
    finally:
        for k in set(os.environ) - set(saved):
            del os.environ[k]
        os.environ.update(saved)
        srv.stop()


def test_run_requires_pyspark():
    try:
        import pyspark  # noqa: F401

        pytest.skip("pyspark installed; the gate does not apply")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="pyspark"):
        hvd_spark.run(_probe_fn, num_proc=2)
    with pytest.raises(ImportError, match="pyspark"):
        hvd_spark.run_elastic(_probe_fn, num_proc=2)


class _FakeKV:
    """An in-memory RendezvousClient (get/put/delete/list)."""

    def __init__(self):
        self.store = {}

    def get(self, scope, key):
        return self.store.get(f"{scope}/{key}")

    def put(self, scope, key, value):
        self.store[f"{scope}/{key}"] = value

    def delete(self, scope, key):
        self.store.pop(f"{scope}/{key}", None)

    def list(self, scope):
        p = scope + "/"
        return [k[len(p):] for k in self.store if k.startswith(p)]


def _reincarnation_trace(task_pool):
    kv = _FakeKV()
    disc = task_pool.SparkTaskPoolDiscovery(kv, stale_after_s=60.0)
    kv.put(task_pool.SCOPE, "hb/0", b"1:incA")
    disc.observe_task(0)
    kv.put(task_pool.SCOPE, "register/0", b"exec0")
    h = task_pool.PoolWorkerHandle(disc, kv, index=0, epoch=1,
                                   incarnation=disc.tracker.incarnation(0))
    trace = [disc.find_available_hosts_and_slots()]
    kv.put(task_pool.SCOPE, "hb/0", b"2:incA")
    trace.append(h.poll())
    kv.put(task_pool.SCOPE, "hb/0", b"1:incB")
    trace.append(h.poll())
    trace.append(disc.find_available_hosts_and_slots())
    h.terminate()
    trace.append(sorted(kv.store))
    return trace


def test_pool_handle_detects_task_reincarnation():
    """A retried task (same index, a fresh incarnation) reports the
    worker of the old one dead though its heartbeat is fresh; the trace
    equals the JAX handle's."""
    from horovod_tpu.spark import task_pool as jpool
    from horovod_tpu_torch.spark import task_pool as ppool

    got = _reincarnation_trace(ppool)
    assert got[1] is None and got[2] == 1
    assert got[0] == {"exec0[0:incA]": 1} and got[3] == {"exec0[0:incB]": 1}
    assert got == _reincarnation_trace(jpool)


def test_heartbeat_tracker_ignores_clock_skew():
    """Liveness is the value changing on the driver's clock; the same
    observations give the JAX tracker's answers."""
    from horovod_tpu.spark.task_pool import _HeartbeatTracker as JTracker
    from horovod_tpu_torch.spark.task_pool import _HeartbeatTracker

    answers = []
    for cls in (_HeartbeatTracker, JTracker):
        tr = cls(stale_after_s=0.3)
        a = [tr.observe(0, "1:x"), tr.observe(0, "2:x"), tr.observe(0, "2:x")]
        time.sleep(0.4)
        a += [tr.observe(0, "2:x"), tr.observe(0, "3:x"),
              tr.observe(1, None), tr.incarnation(0)]
        answers.append(a)
    assert answers[0] == [True, True, True, False, True, False, "x"]
    assert answers[0] == answers[1]


def test_drop_in_signature_knobs_absorbed():
    """Horovod's extra knobs: the same signatures as the JAX adapter's,
    a set knob warned about once, ``verbose >= 2`` lowers the log level,
    unset knobs stay silent, a positional call in Horovod's order
    fails."""
    import logging
    import warnings

    import horovod_tpu.spark as jspark

    for name in ("run", "run_elastic"):
        a = inspect.signature(getattr(hvd_spark, name))
        b = inspect.signature(getattr(jspark, name))
        assert [(p.name, p.kind, p.default) for p in a.parameters.values()] \
            == [(p.name, p.kind, p.default) for p in b.parameters.values()]
    hvd_spark._drop_in_warned = False
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        hvd_spark._absorb_drop_in_knobs("t", verbose=2, use_mpi=True)
        hvd_spark._absorb_drop_in_knobs("t", use_gloo=True)
    assert sum("no meaning here" in str(x.message) for x in w) == 1
    log = logging.getLogger("horovod_tpu_torch")
    assert log.level == logging.DEBUG
    log.setLevel(logging.NOTSET)
    hvd_spark._drop_in_warned = False
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        hvd_spark._absorb_drop_in_knobs(
            "t", verbose=1, nics=None, stdout=None,
            prefix_output_with_timestamp=False)
    assert not w
    with pytest.raises(TypeError):
        hvd_spark.run(_probe_fn, (), None, 2, 300.0)
    with pytest.raises(TypeError):
        hvd_spark.run_elastic(_probe_fn, (), None, 2, 2, 3, 300.0, 300.0,
                              None, None, 1)


# -- Spark: real tasks --------------------------------------------------------

def test_spark_run_reduces_in_a_gloo_world():
    """``spark.run`` over the fake: 2 task processes, one negotiated
    coordinator, an ``init()`` world whose scaled bf16 allreduce equals
    the hand reduction bitwise on both ranks, results in rank order."""
    ctx = FakeSparkContext(default_parallelism=2)
    with world_slot():
        res = hvd_spark.run(_allreduce_fn, num_proc=2, spark_context=ctx,
                            start_timeout=60.0, env={"OMP_NUM_THREADS": "1"})
    want = _hand_allreduce(2).view(torch.int16).tolist()
    assert [r[:2] for r in res] == [(0, 2), (1, 2)]
    assert all(r[2] == want for r in res)
    assert ctx.job_groups == ["horovod_tpu_torch.spark"]


#: A driver that forks its fakes' processes: it has torch imported and
#: has touched no card (what a zygote is), as a child of this test.
FORK_DRIVER = """
import json, os, sys
import torch
import horovod_tpu_torch.spark as hvd_spark
from horovod_tpu_torch.testing import fake_ray
from horovod_tpu_torch.testing.fake_spark import FakeSparkContext
import test_torch_port_spark_ray as t

sys.modules["ray"] = fake_ray
from horovod_tpu_torch.ray import RayExecutor

spark = hvd_spark.run(t._forked_allreduce_fn, num_proc=2, env=t.WORKER_ENV,
                      spark_context=FakeSparkContext(2, start_method="fork"),
                      start_timeout=60.0)
fake_ray.init(start_method="fork")
ex = RayExecutor(RayExecutor.create_settings(60), num_workers=2,
                 env=t.WORKER_ENV)
ex.start()
try:
    ray = ex.run(t._forked_allreduce_fn)
finally:
    ex.shutdown()
    fake_ray.shutdown()
print(json.dumps({"driver": os.getpid(), "spark": spark, "ray": ray}))
"""


def _forked_allreduce_fn():
    """``_allreduce_fn`` with the pid of the process the task was forked
    from: a forked task still holds its driver's ``__main__`` globals."""
    main = sys.modules["__main__"]
    return (*_allreduce_fn(), getattr(main, "FORKED_FROM", None),
            os.getppid())


def test_fakes_fork_their_processes_on_request():
    """``FakeSparkContext(start_method="fork")`` and
    ``fake_ray.init(start_method="fork")``: a driver with torch imported
    (and no card) forks its tasks and actors instead of spawning them;
    both worlds reduce bitwise as the spawned ones do, results in rank
    order, and each process is a fork of the driver."""
    import json
    import subprocess

    code = "FORKED_FROM = __import__('os').getpid()\n" + FORK_DRIVER
    with world_slot():
        out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                             env=dict(os.environ, **WORKER_ENV),
                             capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.splitlines()[-1])
    want = _hand_allreduce(2).view(torch.int16).tolist()
    for world in ("spark", "ray"):
        assert [r[:2] for r in res[world]] == [[0, 2], [1, 2]], world
        assert all(r[2] == want for r in res[world]), world
        assert all(r[3] == r[4] == res["driver"] for r in res[world]), res


def test_spark_run_task_without_gpu_raises():
    """No fallback: a task's ``init()`` without ``device="cpu"`` raises,
    and ``run`` surfaces the task's failure."""
    ctx = FakeSparkContext(default_parallelism=1)
    with pytest.raises(RuntimeError, match="died without producing"):
        hvd_spark.run(_init_default_fn, num_proc=1, spark_context=ctx,
                      start_timeout=60.0)


def test_spark_run_elastic_full_world():
    ctx = FakeSparkContext(default_parallelism=3)
    with world_slot():
        res = hvd_spark.run_elastic(_probe_fn, args=("elastic",),
                                    num_proc=3, min_np=2, max_np=3,
                                    spark_context=ctx, start_timeout=60.0,
                                    elastic_timeout=60.0, env=WORKER_ENV)
    assert [r[1] for r in res] == [0, 1, 2]
    assert all(r[0] == "elastic" and r[2] == 3 for r in res)
    assert len({r[3] for r in res}) == 1


def test_spark_run_elastic_shrinks_on_task_death(monkeypatch):
    """SIGKILL one live task mid-epoch: its heartbeat goes stale, the
    world shrinks, a new epoch completes at np = 2."""
    monkeypatch.setenv("HVD_TPU_ELASTIC_GRACE_SECS", "2")
    ctx = FakeSparkContext(default_parallelism=3)

    def kill_one_task():
        deadline = time.time() + 60.0
        while time.time() < deadline:
            p = ctx.task_processes.get(2)
            if p is not None and p.pid and _children_of(p.pid):
                break
            time.sleep(0.2)
        time.sleep(1.0)
        ctx.kill_task(2)

    killer = threading.Thread(target=kill_one_task, daemon=True)
    with world_slot():
        killer.start()
        res = hvd_spark.run_elastic(_parked_until_shrunk_fn, num_proc=3,
                                    min_np=2, max_np=3, spark_context=ctx,
                                    start_timeout=60.0,
                                    elastic_timeout=120.0, env=WORKER_ENV)
        killer.join(timeout=10.0)
    assert len(res) == 2
    assert all(r[0] == "resumed" and r[2] == 2 for r in res)
    assert sorted(r[1] for r in res) == [0, 1]


def test_spark_run_elastic_grows_on_new_task(monkeypatch):
    """Capacity for 2 of 3 pool tasks, raised mid-epoch: the third task
    registers and the run completes at np = 3."""
    monkeypatch.setenv("HVD_TPU_ELASTIC_GRACE_SECS", "2")
    ctx = FakeSparkContext(default_parallelism=3, max_concurrent_tasks=2)

    def grow_cluster():
        deadline = time.time() + 60.0
        while time.time() < deadline:
            running = [p for p in list(ctx.task_processes.values())
                       if p.is_alive()]
            if len(running) >= 2 and any(_children_of(p.pid)
                                         for p in running):
                break
            time.sleep(0.2)
        time.sleep(1.0)
        ctx.max_concurrent_tasks = 3

    grower = threading.Thread(target=grow_cluster, daemon=True)
    with world_slot():
        grower.start()
        res = hvd_spark.run_elastic(_parked_until_grown_fn, num_proc=2,
                                    min_np=2, max_np=3, spark_context=ctx,
                                    start_timeout=60.0,
                                    elastic_timeout=120.0, env=WORKER_ENV)
        grower.join(timeout=10.0)
    assert len(res) == 3
    assert all(r[0] == "grown" and r[2] == 3 for r in res)
    assert sorted(r[1] for r in res) == [0, 1, 2]


def test_spark_run_elastic_registration_timeout():
    ctx = FakeSparkContext(default_parallelism=1, max_concurrent_tasks=1)
    with pytest.raises(TimeoutError, match="pool tasks"):
        hvd_spark.run_elastic(_probe_fn, args=("x",), num_proc=3, min_np=3,
                              max_np=3, spark_context=ctx,
                              start_timeout=3.0, elastic_timeout=5.0)


# -- Ray ----------------------------------------------------------------------

@pytest.fixture()
def ray_ctx(monkeypatch):
    monkeypatch.setitem(sys.modules, "ray", fake_ray)
    fake_ray.init()
    yield fake_ray
    fake_ray.shutdown()
    fake_ray._reset_nodes()


def test_coordinator_hoststring_and_envs_match_jax():
    from horovod_tpu.ray import Coordinator as JCoordinator
    from horovod_tpu.ray import MiniSettings as JMiniSettings
    from horovod_tpu_torch.ray import Coordinator, MiniSettings

    envs = []
    for coord in (Coordinator(MiniSettings(extra_env={"K": "v"})),
                  JCoordinator(JMiniSettings(extra_env={"K": "v"}))):
        for host, rank in (("hostA", 0), ("hostA", 1), ("hostB", 2)):
            coord.register(host, rank)
        coord.coordinator_port = 29501
        assert coord.world_size == 3 and coord.hoststring == "hostA:2,hostB:1"
        envs.append(coord.finalize_registration())
    assert envs[0] == envs[1]
    assert envs[0][2]["HVD_TPU_LOCAL_RANK"] == "0"
    assert envs[0][1]["HVD_TPU_COORDINATOR"] == "hostA:29501"


class _Trainer:
    def __init__(self, base):
        self.base = base

    def bump(self, k):
        self.base += k
        return self.base


def _bump5(t):
    return t.bump(5)


def _bump1(t):
    return t.bump(1)


def _slot_probe():
    return (int(os.environ["HVD_TPU_PROC_ID"]),
            int(os.environ["HVD_TPU_NUM_PROC"]),
            int(os.environ["HVD_TPU_LOCAL_RANK"]))


def _whoami():
    return int(os.environ["HVD_TPU_PROC_ID"])


def _boom():
    raise ValueError("worker exploded")


def test_ray_executor_cases(ray_ctx):
    """``test_ray.py``'s RayExecutor cases on one pool of 2 actors: run
    in rank order with the slot environment, the executable class and
    ``execute`` with state kept across calls, ``execute_single``,
    ``run_remote``, a worker's error, a gloo world whose scaled bf16
    allreduce equals the hand value bitwise, and shutdown killing the
    actors."""
    from horovod_tpu_torch.ray import RayExecutor

    with pytest.raises(RuntimeError, match="not started"):
        RayExecutor(num_workers=1).run(_whoami)
    ex = RayExecutor(RayExecutor.create_settings(60), num_workers=2,
                     env=WORKER_ENV)
    with world_slot():
        ex.start(executable_cls=_Trainer, executable_args=[10])
        try:
            assert ex.num_workers == 2
            assert ex.run(_slot_probe) == [(0, 2, 0), (1, 2, 1)]
            assert ex.execute(_bump5) == [15, 15]
            assert ex.execute(_bump1) == [16, 16]
            assert ex.execute_single(_whoami, rank=1) == 1
            assert fake_ray.get(ex.run_remote(_whoami)) == [0, 1]
            with pytest.raises(Exception, match="worker exploded"):
                ex.run(_boom)
            res = ex.run(_allreduce_fn)
        finally:
            procs = [w._proc for w in ex.workers]
            ex.shutdown()
    want = _hand_allreduce(2).view(torch.int16).tolist()
    assert [r[:2] for r in res] == [(0, 2), (1, 2)]
    assert all(r[2] == want for r in res)
    for p in procs:
        p.join(timeout=10)
        assert not p.is_alive()
    assert ex.workers == []


def test_ray_worker_init_without_gpu_raises(ray_ctx):
    from horovod_tpu_torch.ray import RayExecutor

    ex = RayExecutor(num_workers=1, env=WORKER_ENV)
    ex.start()
    try:
        with pytest.raises(Exception, match="no CUDA device"):
            ex.run(_init_default_fn)
    finally:
        ex.shutdown()


@pytest.mark.parametrize("nodes,use_gpu", [
    (None, False), (None, True),
    ({"nodeA": 4.0, "nodeB": 1.0}, False), ({"nodeA": 3.0}, True)])
def test_ray_host_discovery_matches_jax(ray_ctx, monkeypatch, nodes,
                                        use_gpu):
    from horovod_tpu.ray import RayHostDiscovery as JDiscovery
    from horovod_tpu_torch.ray import RayHostDiscovery

    if nodes is not None:
        fake_ray._set_nodes(nodes)
        fake_ray._remove_node("nodeB")
    got = RayHostDiscovery(use_gpu=use_gpu, cpus_per_slot=2) \
        .find_available_hosts_and_slots()
    want = JDiscovery(use_gpu=use_gpu, cpus_per_slot=2) \
        .find_available_hosts_and_slots()
    assert got == want
    if use_gpu:
        assert got == {}


def test_elastic_collect_results_matches_jax(tmp_path):
    """Stale files of an aborted epoch are left out; ranks order
    numerically; the same answer as the JAX collector."""
    import pickle

    from horovod_tpu.ray import ElasticRayExecutor as JElastic
    from horovod_tpu_torch.ray import ElasticRayExecutor

    d = str(tmp_path)

    def drop(rank, world, value, mtime_offset):
        p = os.path.join(d, f"rank_{rank}_of_{world}.pkl")
        with open(p, "wb") as f:
            pickle.dump(value, f)
        t = time.time() + mtime_offset
        os.utime(p, (t, t))

    for r in range(4):
        drop(r, 4, f"stale{r}", -100)
    for r in range(11):
        drop(r, 11, f"final{r}", 0)
    out = ElasticRayExecutor._collect_results(d)
    assert out == [f"final{r}" for r in range(11)]
    assert out == JElastic._collect_results(d)
    assert ElasticRayExecutor._collect_results(d + "/none") == []


def test_elastic_ray_executor_requires_capacity(ray_ctx):
    from horovod_tpu_torch.ray import ElasticRayExecutor

    ex = ElasticRayExecutor(ElasticRayExecutor.create_settings(
        min_np=10 ** 6))
    with pytest.raises(RuntimeError, match="slots"):
        ex.start()
    with pytest.raises(TypeError):
        ElasticRayExecutor.create_settings(min_np=1, typo=3)


def _elastic_done():
    return ("done", int(os.environ["HVD_TPU_PROC_ID"]))


def test_elastic_ray_executor_runs(ray_ctx, monkeypatch):
    from horovod_tpu_torch.ray import ElasticRayExecutor

    monkeypatch.setenv("HVD_TPU_ELASTIC_FORCE_LOCAL", "1")
    ex = ElasticRayExecutor(ElasticRayExecutor.create_settings(
        min_np=1, max_np=2), env_vars=WORKER_ENV)
    ex.start()
    with world_slot():
        results = ex.run(_elastic_done)
    assert 1 <= len(results) <= 2
    assert all(r[0] == "done" for r in results)
    assert sorted(r[1] for r in results) == list(range(len(results)))


class _GrowingDiscovery:
    def __init__(self, marker):
        self.marker = marker

    def find_available_hosts_and_slots(self):
        hosts = {"hostA": 1}
        if os.path.exists(self.marker):
            hosts["hostB"] = 1
        return hosts


def _grow_work(marker, sizes_log):
    """A gloo world on the CPU under ``elastic.run``: at size 1 it drops
    the marker that grows the cluster and commits until the driver's
    host update ends the epoch; at size 2 it finishes its steps."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.elastic import ObjectState

    hvd.init(device="cpu")
    state = ObjectState(step=0)

    @hvd.elastic.run
    def train(state):
        while state.step < 6:
            hvd.allreduce(torch.ones(2), op=hvd.Sum, name="g")
            state.step += 1
            if state.step == 2 and hvd.size() == 1:
                open(marker, "w").write("1")
            if state.step >= 3 and hvd.size() == 1:
                for _ in range(100):
                    time.sleep(0.2)
                    state.commit()
            state.commit()
            with open(sizes_log, "a") as f:
                f.write(f"{state.step} {hvd.size()}\n")

    train(state)
    return hvd.size()


def test_elastic_ray_executor_scales_up(ray_ctx, monkeypatch, tmp_path):
    """The cluster grows mid-run (discovery adds a host once a worker
    drops a marker): with ``max_np=None`` the driver interrupts and
    restarts with the larger world, which reduces in one gloo world."""
    import functools

    from horovod_tpu_torch.ray import ElasticRayExecutor

    monkeypatch.setenv("HVD_TPU_ELASTIC_FORCE_LOCAL", "1")
    marker, sizes_log = str(tmp_path / "grow"), str(tmp_path / "sizes.log")
    ex = ElasticRayExecutor(
        ElasticRayExecutor.create_settings(min_np=1, timeout_s=20),
        override_discovery=False, env_vars=WORKER_ENV)
    ex.discovery = _GrowingDiscovery(marker)
    ex.start()
    with world_slot():
        results = ex.run(functools.partial(_grow_work, marker, sizes_log))
    assert results == [2, 2]
    recs = [tuple(map(int, line.split()))
            for line in open(sizes_log).read().splitlines()]
    assert any(size == 1 for _, size in recs), "never ran small"
    assert recs[-1][1] == 2, recs[-5:]


def _park_at_two(spawned):
    world = int(os.environ["HVD_TPU_NUM_PROC"])
    open(f"{spawned}.{os.environ['HVD_TPU_PROC_ID']}", "w").close()
    if world >= 2:
        for _ in range(600):
            time.sleep(0.5)
        return ("never", world)
    return ("resumed", world)


def test_elastic_ray_executor_shrinks_on_node_death(ray_ctx, monkeypatch,
                                                    tmp_path):
    """A node dies mid-epoch (``Alive`` false in ``ray.nodes()``): the
    world shrinks to the survivor and the run completes at size 1."""
    import functools

    from horovod_tpu_torch.ray import ElasticRayExecutor

    monkeypatch.setenv("HVD_TPU_ELASTIC_FORCE_LOCAL", "1")
    spawned = str(tmp_path / "spawned")
    fake_ray._set_nodes({"nodeA": 1.0, "nodeB": 1.0})
    # timeout_s: the parked workers' grace window before they are ended.
    ex = ElasticRayExecutor(ElasticRayExecutor.create_settings(
        min_np=1, timeout_s=2), env_vars=WORKER_ENV)
    ex.start()
    assert ex.discovery.find_available_hosts_and_slots() == \
        {"nodeA": 1, "nodeB": 1}

    def kill_node():
        deadline = time.time() + 60.0
        while time.time() < deadline and not os.path.exists(spawned + ".1"):
            time.sleep(0.2)
        time.sleep(1.0)
        fake_ray._remove_node("nodeB")

    killer = threading.Thread(target=kill_node, daemon=True)
    with world_slot():
        killer.start()
        results = ex.run(functools.partial(_park_at_two, spawned))
        killer.join(timeout=10.0)
    assert results == [("resumed", 1)]
