"""A process-backed stand-in for the slice of the pyspark API that
:mod:`horovod_tpu_torch.spark` uses — the port's copy of
``horovod_tpu/testing/fake_spark.py``, for machines without pyspark.

* Tasks are real OS processes of the ``multiprocessing`` spawn context,
  as Spark's executor tasks are: a mapper may change ``os.environ``,
  start worker subprocesses (the elastic task pool) and be killed to
  stand for a lost executor. Spawn, not fork: a forked child of a
  process that holds a CUDA context cannot use the card.
  ``start_method="fork"`` forks them instead, for a driver that has
  touched no card and has its imports done (tasks then start at once).
* The mapper chain travels by cloudpickle where it is installed, else by
  pickle (then every mapper must be importable by name; the port's are).
* ``collect()`` blocks until every task has finished, returns the
  results in partition order, and raises when a task died without
  producing its partition (a failed Spark job surfacing in collect).

The API: ``SparkContext(defaultParallelism)``, ``getConf().get``,
``parallelize(seq, numSlices)``, ``RDD.mapPartitionsWithIndex``,
``RDD.collect``, ``setJobGroup``, ``cancelJobGroup``. Test hooks:
``task_processes`` (index -> live Process) and ``kill_task(index)``.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as queue_lib
from typing import Any, Callable, Dict, List, Optional

from ..runner.task_fn import _pickler

def _task_main(out_queue, index: int, chain_blob: bytes,
               items: List[Any]) -> None:
    chain = _pickler().loads(chain_blob)
    data = iter(items)
    for f in chain:
        data = f(index, data)
    out_queue.put((index, list(data)))


def elastic_probe_fn():
    """A worker function for the elastic smoke legs: importable by name,
    so elastic workers unpickle it without cloudpickle."""
    from horovod_tpu_torch.common.config import runtime_env

    return (int(runtime_env("PROC_ID", required=True)),
            int(runtime_env("NUM_PROC", required=True)),
            runtime_env("COORDINATOR", required=True))


class FakeSparkConf:
    def __init__(self, values: Optional[Dict[str, str]] = None):
        self._values = dict(values or {})

    def get(self, key: str, default: Optional[str] = None):
        return self._values.get(key, default)


class FakeRDD:
    def __init__(self, ctx: "FakeSparkContext",
                 partitions: List[List[Any]],
                 chain: Optional[List[Callable]] = None):
        self._ctx = ctx
        self._partitions = partitions
        self._chain = list(chain or [])

    def mapPartitionsWithIndex(self, f: Callable) -> "FakeRDD":
        return FakeRDD(self._ctx, self._partitions, self._chain + [f])

    def collect(self) -> List[Any]:
        ctx = mp.get_context(self._ctx.start_method)
        blob = _pickler().dumps(self._chain)
        out_queue = ctx.Queue()
        procs: Dict[int, Any] = {}
        pending = list(enumerate(self._partitions))

        def _schedule():
            # Spark's scheduler: at most `cap` tasks at once, the rest
            # wait for a free slot (what starves a pool too large for the
            # cluster). The cap is read again each pass, so a test can
            # grow the cluster while the job runs.
            cap = self._ctx.max_concurrent_tasks or len(self._partitions)
            while pending and \
                    sum(p.is_alive() for p in procs.values()) < cap:
                i, part = pending.pop(0)
                p = ctx.Process(target=_task_main,
                                args=(out_queue, i, blob, part),
                                daemon=True)
                p.start()
                procs[i] = p
                self._ctx.task_processes[i] = p

        _schedule()
        results: Dict[int, List[Any]] = {}
        while len(results) < len(self._partitions):
            _schedule()
            try:
                i, values = out_queue.get(timeout=0.5)
                results[i] = values
                continue
            except queue_lib.Empty:
                pass
            if self._ctx._cancelled:
                for p in procs.values():
                    if p.is_alive():
                        p.terminate()
                raise RuntimeError("job group cancelled")
            dead = [i for i, p in procs.items()
                    if not p.is_alive() and i not in results]
            if dead:
                # Results that raced the liveness check.
                try:
                    while True:
                        i, values = out_queue.get_nowait()
                        results[i] = values
                except queue_lib.Empty:
                    pass
                dead = [i for i in dead if i not in results]
                if dead:
                    raise RuntimeError(
                        f"Spark tasks {sorted(dead)} died without "
                        f"producing their partitions (executor lost)")
        for p in procs.values():
            p.join(timeout=5)
        return [v for i in sorted(results) for v in results[i]]


class FakeSparkContext:
    """The SparkContext surface horovod_tpu_torch.spark touches."""

    def __init__(self, default_parallelism: int = 2,
                 conf: Optional[Dict[str, str]] = None,
                 max_concurrent_tasks: Optional[int] = None,
                 start_method: str = "spawn"):
        self.defaultParallelism = default_parallelism
        self.start_method = start_method
        self._conf = FakeSparkConf(
            {"spark.driver.host": "127.0.0.1", **(conf or {})})
        self._cancelled = False
        self.job_groups: List[str] = []
        self.task_processes: Dict[int, Any] = {}
        self.max_concurrent_tasks = max_concurrent_tasks

    def getConf(self) -> FakeSparkConf:
        return self._conf

    def parallelize(self, seq, numSlices: int = None) -> FakeRDD:
        items = list(seq)
        n = numSlices or self.defaultParallelism
        # Spark's range partitioning: contiguous, balanced slices.
        base, extra = divmod(len(items), n)
        partitions, start = [], 0
        for i in range(n):
            size = base + (1 if i < extra else 0)
            partitions.append(items[start:start + size])
            start += size
        return FakeRDD(self, partitions)

    def setJobGroup(self, group: str, description: str = "",
                    interruptOnCancel: bool = False) -> None:
        self.job_groups.append(group)

    def cancelJobGroup(self, group: str) -> None:
        self._cancelled = True
        for p in self.task_processes.values():
            if p.is_alive():
                p.terminate()

    # -- test hooks (not pyspark API) -----------------------------------

    def kill_task(self, index: int) -> None:
        """SIGKILL a live task process: an executor lost."""
        p = self.task_processes.get(index)
        if p is not None and p.is_alive():
            p.kill()
            p.join(timeout=5)
