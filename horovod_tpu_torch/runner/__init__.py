"""The port's launcher: ``hvdtpurun-torch`` (``launch.py``), the
rendezvous KV (``rendezvous.py``), host assignment (``hosts.py``), the
elastic driver (``elastic_driver.py``) and the programmatic
:func:`run` — the counterpart of ``horovod_tpu/runner/``.
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
from typing import Any, Callable, Dict, List, Optional


def run(func: Callable,
        args: tuple = (),
        kwargs: Optional[Dict[str, Any]] = None,
        np: int = 2,
        hosts: Optional[str] = None,
        env: Optional[Dict[str, str]] = None,
        use_ssh: bool = False,
        verbose: bool = False) -> List[Any]:
    """Run ``func(*args, **kwargs)`` on ``np`` workers on this machine,
    wired as the launcher wires them (inside, ``hvd.init()`` joins the
    world), and return their results ordered by rank. A worker's
    exception raises here as ``RuntimeError`` carrying its traceback.
    ``func`` travels by cloudpickle where it is installed, else by
    pickle (then it must be importable by the workers).

    ``use_ssh=True`` (workers on ``hosts`` over ssh) is not ported yet:
    it raises ``NotImplementedError`` naming the ssh/LSF launch slice;
    ``hosts`` naming only this machine is accepted."""
    from . import hosts as hosts_lib
    from . import launch as launch_lib
    from .task_fn import _pickler

    if use_ssh:
        raise NotImplementedError(
            "run(use_ssh=True) is not ported yet; it comes with "
            f"{launch_lib._SSH_SLICE} of the port")
    if hosts:
        infos = hosts_lib.parse_hosts(hosts)
        hosts_lib.get_host_assignments(infos, np)
        if not launch_lib._is_local(infos):
            raise NotImplementedError(
                "run(hosts=) beyond this machine is not ported yet; it "
                f"comes with {launch_lib._SSH_SLICE} of the port")
    kwargs = kwargs or {}
    with tempfile.TemporaryDirectory(prefix=".hvd_tpu_torch_run_") as tmp:
        payload = os.path.join(tmp, "payload.pkl")
        with open(payload, "wb") as f:
            _pickler().dump((func, args, kwargs), f)
        command = [sys.executable, "-m", "horovod_tpu_torch.runner.task_fn",
                   payload, tmp]
        rc = launch_lib.run_local(np, command, dict(env or {}),
                                  verbose=verbose)
        results: List[Any] = []
        errors: List[str] = []
        for pid in range(np):
            path = os.path.join(tmp, f"result_{pid}.pkl")
            if not os.path.exists(path):
                errors.append(f"worker {pid}: no result (crashed?)")
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status == "error":
                errors.append(f"worker {pid}:\n{value}")
            else:
                results.append(value)
        if rc != 0 or errors:
            raise RuntimeError(
                "run() failed (exit code %d):\n%s" % (rc, "\n".join(errors)))
        return results
