"""A process-backed stand-in for the slice of the ``ray`` API that
:mod:`horovod_tpu_torch.ray` uses — the port's copy of
``horovod_tpu/testing/fake_ray.py``, for machines without ray.

* Actors are real OS processes of the ``multiprocessing`` spawn context,
  as Ray's are, so ``RayExecutor`` workers set their slot environment
  and form a real multi-process ``torch.distributed`` world. Spawn, not
  fork: a forked child of a process that holds a CUDA context cannot
  use the card. ``init(start_method="fork")`` forks them instead, for a
  driver that has touched no card and has its imports done.
* Method calls are asynchronous: ``handle.method.remote(...)`` returns
  an ObjectRef at once, and a dispatch thread an actor keeps every
  actor busy at the same time (sequential dispatch would deadlock a
  collective).
* Classes, calls and results travel by cloudpickle where it is
  installed, else by pickle (then they must be importable by name).

The API: ``init/is_initialized/shutdown``, ``remote(cls)`` (and
``.options()``), an actor's ``.remote()`` construction, methods'
``.remote()``, ``get(ref|list, timeout=)``, ``kill(handle)``,
``nodes()``; test hooks ``_set_nodes``, ``_remove_node``,
``_reset_nodes`` script node arrival and loss.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import threading
import traceback
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

from ..runner.task_fn import _pickler

_STATE: Dict[str, Any] = {"initialized": False, "actors": [],
                          "start_method": "spawn"}


def init(*args, start_method: str = "spawn", **kwargs) -> None:
    _STATE["initialized"] = True
    _STATE["start_method"] = start_method


def is_initialized() -> bool:
    return bool(_STATE["initialized"])


def shutdown() -> None:
    for actor in list(_STATE["actors"]):
        actor._terminate()
    _STATE["actors"] = []
    _STATE["initialized"] = False
    _STATE["start_method"] = "spawn"


def nodes() -> List[Dict[str, Any]]:
    if _STATE.get("nodes") is not None:
        return [dict(n) for n in _STATE["nodes"]]
    return [{
        "Alive": True,
        "NodeManagerHostname": socket.gethostname(),
        "NodeManagerAddress": "127.0.0.1",
        "Resources": {"CPU": float(os.cpu_count() or 1)},
    }]


# -- dynamic cluster membership (test hooks, not ray API) -------------------
#
# RayHostDiscovery reads ray.nodes() on every elastic discovery poll;
# these hooks let tests script node arrival/loss (the autoscaling and
# node-death scenarios Horovod's ElasticRayExecutor rides Ray
# for) without a real cluster.

def _set_nodes(hostnames_to_cpus: Dict[str, float]) -> None:
    _STATE["nodes"] = [{
        "Alive": True,
        "NodeManagerHostname": h,
        "NodeManagerAddress": "127.0.0.1",
        "Resources": {"CPU": float(c)},
    } for h, c in hostnames_to_cpus.items()]


def _remove_node(hostname: str) -> None:
    """Simulate node loss: the node drops from ray.nodes() (Ray also
    reports dead nodes with Alive=False for a while — model both)."""
    kept = []
    for n in _STATE.get("nodes") or []:
        if n["NodeManagerHostname"] == hostname:
            dead = dict(n)
            dead["Alive"] = False
            kept.append(dead)
        else:
            kept.append(n)
    _STATE["nodes"] = kept


def _reset_nodes() -> None:
    _STATE["nodes"] = None


def _actor_main(conn, cls_blob: bytes) -> None:
    """Child process: build the instance, serve method calls forever."""
    pickler = _pickler()
    cls, args, kwargs = pickler.loads(cls_blob)
    try:
        instance = cls(*args, **kwargs)
        conn.send_bytes(pickler.dumps(("ok", None)))
    except BaseException:
        conn.send_bytes(pickler.dumps(
            ("error", traceback.format_exc())))
        return
    while True:
        try:
            blob = conn.recv_bytes()
        except EOFError:
            return
        msg = pickler.loads(blob)
        if msg[0] == "stop":
            return
        _, method, args, kwargs = msg
        try:
            reply = ("ok", getattr(instance, method)(*args, **kwargs))
        except BaseException:
            reply = ("error", traceback.format_exc())
        conn.send_bytes(pickler.dumps(reply))


class ObjectRef:
    def __init__(self, future: Future):
        self._future = future


class _RemoteMethod:
    def __init__(self, actor: "ActorHandle", name: str):
        self._actor, self._name = actor, name

    def remote(self, *args, **kwargs) -> ObjectRef:
        return self._actor._call(self._name, args, kwargs)


class ActorHandle:
    """One spawned process + a dispatch thread serializing its calls."""

    def __init__(self, cls: type, args: tuple, kwargs: dict):
        pickler = _pickler()
        ctx = mp.get_context(_STATE["start_method"])
        parent, child = ctx.Pipe()
        self._conn = parent
        self._proc = ctx.Process(
            target=_actor_main,
            args=(child, pickler.dumps((cls, args, kwargs))),
            daemon=True)
        self._proc.start()
        child.close()
        status, detail = pickler.loads(self._conn.recv_bytes())
        if status != "ok":
            self._proc.join(timeout=5)
            raise RuntimeError(f"actor constructor failed:\n{detail}")
        self._queue: "queue.Queue" = queue.Queue()
        self._alive = True
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True)
        self._thread.start()
        _STATE["actors"].append(self)

    def _dispatch_loop(self) -> None:
        pickler = _pickler()
        while True:
            item = self._queue.get()
            if item is None:
                return
            method, args, kwargs, future = item
            try:
                self._conn.send_bytes(
                    pickler.dumps(("call", method, args, kwargs)))
                status, value = pickler.loads(self._conn.recv_bytes())
            except (EOFError, OSError) as e:
                future.set_exception(
                    RuntimeError(f"actor died: {e!r}"))
                continue
            if status == "ok":
                future.set_result(value)
            else:
                future.set_exception(RayTaskError(value))

    def _call(self, method: str, args: tuple, kwargs: dict) -> ObjectRef:
        if not self._alive:
            raise RuntimeError("actor has been killed")
        future: Future = Future()
        self._queue.put((method, args, kwargs, future))
        return ObjectRef(future)

    def _terminate(self) -> None:
        if not self._alive:
            return
        self._alive = False
        self._queue.put(None)
        try:
            self._conn.send_bytes(_pickler().dumps(("stop",)))
        except (OSError, ValueError):
            pass
        self._proc.join(timeout=10)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join(timeout=5)
        self._conn.close()

    def __getattr__(self, name: str) -> _RemoteMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return _RemoteMethod(self, name)


class RayTaskError(RuntimeError):
    """Remote traceback carrier (ray.exceptions.RayTaskError analog)."""


class _RemoteClass:
    def __init__(self, cls: type, options: Optional[dict] = None):
        self._cls = cls
        self._options = dict(options or {})

    def options(self, **opts) -> "_RemoteClass":
        return _RemoteClass(self._cls, {**self._options, **opts})

    def remote(self, *args, **kwargs) -> ActorHandle:
        if not _STATE["initialized"]:
            raise RuntimeError("ray.init() has not been called")
        return ActorHandle(self._cls, args, kwargs)


def remote(cls=None, **opts):
    if cls is None:  # @ray.remote(num_cpus=...) decorator form
        return lambda c: _RemoteClass(c, opts)
    return _RemoteClass(cls)


def get(refs, timeout: Optional[float] = None):
    if isinstance(refs, ObjectRef):
        return refs._future.result(timeout=timeout)
    return [r._future.result(timeout=timeout) for r in refs]


def kill(actor: ActorHandle) -> None:
    actor._terminate()
