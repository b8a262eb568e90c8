"""The port's launcher: ``hvdtpurun-torch`` (``launch.py``: the local
launch and the ssh fan-out, one process a slot), the rendezvous KV
(``rendezvous.py``), host assignment (``hosts.py``), LSF hosts
(``lsf.py``), NIC discovery (``driver_service.py``), this machine's GPUs
(``gpu_hosts.py``), the elastic driver (``elastic_driver.py``) and the
programmatic :func:`run` — the counterpart of ``horovod_tpu/runner/``.
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
    """Run ``func(*args, **kwargs)`` on ``np`` workers, wired as the
    launcher wires them (inside, ``hvd.init()`` joins the world), and
    return their results ordered by rank. A worker's exception raises
    here as ``RuntimeError`` carrying its traceback. ``func`` travels by
    cloudpickle where it is installed, else by pickle (then it must be
    importable by the workers).

    The workers run on this machine, or with ``use_ssh=True`` (or
    ``hosts`` naming another machine) over ssh on ``hosts``
    (``"h1:2,h2:2"``), one process a slot, through
    ``launch.run_ssh``. Payload and results then travel through a
    directory under the current one, which every host must be able to
    read and write (a shared filesystem), as in the JAX ``run()``."""
    from . import hosts as hosts_lib
    from . import launch as launch_lib
    from .task_fn import _pickler

    infos = None
    if hosts:
        infos = hosts_lib.parse_hosts(hosts)
        hosts_lib.get_host_assignments(infos, np)
    if use_ssh and infos is None:
        raise ValueError("use_ssh=True requires hosts=")
    remote = use_ssh or not launch_lib._is_local(infos)
    kwargs = kwargs or {}
    with tempfile.TemporaryDirectory(
            prefix=".hvd_tpu_torch_run_",
            dir=os.getcwd() if remote else None) as tmp:
        payload = os.path.join(tmp, "payload.pkl")
        with open(payload, "wb") as f:
            _pickler().dump((func, args, kwargs), f)
        command = [sys.executable, "-m", "horovod_tpu_torch.runner.task_fn",
                   payload, tmp]
        if remote:
            rc = launch_lib.run_ssh(infos, command, dict(env or {}), np,
                                    verbose=verbose)
        else:
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
