"""The persistent worker pool of the cluster layer — the port's copy of
``horovod_tpu/executor.py`` (Horovod's ``RayExecutor`` contract: workers
that stay alive across ``run()`` calls, per-rank results in rank order).

Workers are OS processes (``python -m horovod_tpu_torch.executor``)
wired into one world by the launcher's environment
(``runner.launch.build_env_for_slot``), so ``hvd.init()`` inside a
function run on them joins that world, and a world, the built kernels
and the model's state survive from one ``run()`` to the next. The
driver talks to each worker over length-prefixed pickle frames on a
loopback socket. Functions and their arguments travel by cloudpickle
where it is installed, else by pickle: a function sent must then be
importable by name in the workers (a module-level function of a module
on their path; they start in the caller's directory).
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import subprocess
import sys
import threading
from typing import Any, Callable, Dict, List, Optional

from .common.config import runtime_env
from .runner.task_fn import _pickler


# -- framing ----------------------------------------------------------------

def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack(">Q", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 24))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> bytes:
    (n,) = struct.unpack(">Q", _recv_exact(sock, 8))
    return _recv_exact(sock, n)


class Executor:
    """A pool of ``np`` persistent workers; :meth:`run` calls a function
    on every worker and returns the results in rank order.

    Usage::

        with hvd.executor.Executor(np=2) as ex:
            ex.run(setup_fn)          # hvd.init() once, stays up
            for epoch in range(10):
                losses = ex.run(train_epoch, args=(epoch,))
    """

    def __init__(self, np: int = 2, env: Optional[Dict[str, str]] = None,
                 start_timeout_s: float = 60.0):
        self.np = np
        self.env = dict(env or {})
        self.start_timeout_s = start_timeout_s
        self._procs: List[subprocess.Popen] = []
        self._socks: Dict[int, socket.socket] = {}
        self._server: Optional[socket.socket] = None
        self._started = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Executor":
        from .runner import launch as launch_lib

        if self._started:
            return self
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("127.0.0.1", 0))
        self._server.listen(self.np)
        self._server.settimeout(self.start_timeout_s)
        driver_addr = "127.0.0.1:%d" % self._server.getsockname()[1]

        coordinator = "127.0.0.1:%d" % launch_lib._free_port()
        try:
            for i in range(self.np):
                env = launch_lib.build_env_for_slot(
                    dict(os.environ), coordinator, self.np, i, self.env)
                p = subprocess.Popen(
                    [sys.executable, "-m", "horovod_tpu_torch.executor",
                     driver_addr], env=env)
                self._procs.append(p)
            for _ in range(self.np):
                sock, _ = self._server.accept()
                pid = pickle.loads(_recv_frame(sock))
                self._socks[pid] = sock
        except BaseException:
            # A worker died before connecting (or accept timed out): a
            # failed start leaks no process and no socket (start() raising
            # skips __exit__).
            for p in self._procs:
                p.kill()
            for p in self._procs:
                p.wait()
            for sock in self._socks.values():
                sock.close()
            self._server.close()
            self._procs.clear()
            self._socks.clear()
            self._server = None
            raise
        self._started = True
        return self

    def shutdown(self) -> None:
        for sock in self._socks.values():
            try:
                _send_frame(sock, pickle.dumps(("stop", None)))
                sock.close()
            except OSError:
                pass
        for p in self._procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if self._server is not None:
            self._server.close()
            self._server = None
        self._socks.clear()
        self._procs.clear()
        self._started = False

    def __enter__(self) -> "Executor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- execution ---------------------------------------------------------

    def run(self, fn: Callable, args: tuple = (),
            kwargs: Optional[Dict[str, Any]] = None) -> List[Any]:
        """Run ``fn(*args, **kwargs)`` on every worker; returns the
        results in rank order. A worker's exception raises RuntimeError
        with the remote traceback, after every worker has finished the
        round (a collective must not lose its peers halfway)."""
        if not self._started:
            raise RuntimeError("Executor not started (use .start() or with)")
        payload = _pickler().dumps(("run", (fn, args, kwargs or {})))
        results: Dict[int, Any] = {}
        errors: Dict[int, str] = {}
        lock = threading.Lock()

        def one(pid: int, sock: socket.socket) -> None:
            try:
                _send_frame(sock, payload)
                status, value = pickle.loads(_recv_frame(sock))
                with lock:
                    (results if status == "ok" else errors)[pid] = value
            except (OSError, ConnectionError, EOFError) as e:
                with lock:
                    errors[pid] = f"transport error: {e!r}"

        threads = [threading.Thread(target=one, args=item)
                   for item in self._socks.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            detail = "\n".join(f"worker {pid}:\n{tb}"
                               for pid, tb in sorted(errors.items()))
            raise RuntimeError(f"Executor.run failed:\n{detail}")
        return [results[pid] for pid in sorted(results)]

    def execute_single(self, fn: Callable, args: tuple = (),
                       kwargs: Optional[Dict[str, Any]] = None,
                       rank: int = 0) -> Any:
        """Run on one worker only (``RayExecutor.execute_single``).
        ``fn`` must not issue collectives: the other ranks take no part
        in this call."""
        if not self._started:
            raise RuntimeError("Executor not started (use .start() or with)")
        sock = self._socks[rank]
        _send_frame(sock, _pickler().dumps(("run", (fn, args,
                                                    kwargs or {}))))
        status, value = pickle.loads(_recv_frame(sock))
        if status != "ok":
            raise RuntimeError(f"worker {rank}:\n{value}")
        return value


# -- worker side ------------------------------------------------------------

def _worker_main(driver_addr: str) -> int:
    import traceback

    host, port = driver_addr.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)))
    pid = int(runtime_env("PROC_ID", "0"))
    _send_frame(sock, pickle.dumps(pid))
    loads = _pickler().loads
    while True:
        try:
            frame = _recv_frame(sock)
        except ConnectionError:
            return 0            # the driver went away: nothing to serve
        try:
            # A function that does not unpickle here (pickle without
            # cloudpickle: not importable by name) is this call's error.
            cmd, payload = loads(frame)
            if cmd == "stop":
                return 0
            fn, args, kwargs = payload
            blob = pickle.dumps(("ok", fn(*args, **kwargs)))
        except BaseException as e:
            blob = pickle.dumps(("error", "".join(traceback.format_exception(
                type(e), e, e.__traceback__))))
        _send_frame(sock, blob)


if __name__ == "__main__":
    sys.exit(_worker_main(sys.argv[1]))
