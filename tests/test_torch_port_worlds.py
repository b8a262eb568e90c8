"""How the port's CPU tests start their gloo worlds, and a test of it.

Every port test that needs several ranks starts them as processes
running its own file (``python <test file> --<flag>-worker RANK ...``)
through :func:`run_ranks`. The test suite runs under pytest-xdist, so
several workers may want a world at the same moment, while the JAX
package's tests in the other workers run XLA's in-process collectives,
whose rendezvous aborts the process when its device threads are starved
of CPU for too long. So at most one world runs at a time in a session:
:func:`world_slot` is an exclusive ``flock`` on one file in the
temporary directory, which every worker of the session shares. Each
rank also runs one torch thread (``OMP_NUM_THREADS=1``): the ranks are
small and share the host with the rest of the suite.
"""

import contextlib
import fcntl
import os
import socket
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
LOCK_NAME = "hvd_tpu_torch_gloo_worlds.lock"
#: The environment of a process that runs TensorFlow: its default thread
#: pools take every core and spin between ops, which starves the rest of
#: the suite; one intra-op and two inter-op threads (a graph's
#: ``py_function`` collectives run on the inter-op pool), quiet logs.
TF_ENV = {"TF_NUM_INTRAOP_THREADS": "1", "TF_NUM_INTEROP_THREADS": "2",
          "TF_CPP_MIN_LOG_LEVEL": "2"}


@contextlib.contextmanager
def world_slot(path=None):
    """Hold the session's one world slot (blocks until it is free);
    ``path`` names another lock file."""
    path = path or os.path.join(tempfile.gettempdir(), LOCK_NAME)
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(n=None, **extra) -> dict:
    """The environment of a rank process: one torch thread, the repo on
    ``PYTHONPATH`` and, for a world of ``n``, a launcher's coordinator
    and world size (``HVD_TPU_PROC_ID`` is set per rank)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    if n is not None:
        env.update(HVD_TPU_COORDINATOR=f"127.0.0.1:{free_port()}",
                   HVD_TPU_NUM_PROC=str(n))
    env.update(extra)
    return env


def run_procs(cmds: dict, timeout: float) -> dict:
    """Run ``{key: (argv, env)}`` side by side inside the world slot;
    returns each process's output and asserts that every one exited 0,
    naming the first that did not with its output."""
    with world_slot():
        procs = {key: subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
                 for key, (argv, env) in cmds.items()}
        logs = {}
        try:
            for key, p in procs.items():
                logs[key] = p.communicate(timeout=timeout)[0]
        finally:
            for p in procs.values():
                p.kill()
                p.wait()
    for key, p in procs.items():
        assert p.returncode == 0, f"{key} failed:\n{logs[key]}"
    return logs


def run_ranks(script, args_of, n: int, timeout: float = 180, **env_extra):
    """Start ``n`` ranks of ``script`` (rank ``r`` runs ``python script
    *args_of(r)`` with ``HVD_TPU_PROC_ID=r``) in one world and wait for
    them all; returns their outputs."""
    env = rank_env(n, **env_extra)
    logs = run_procs({f"rank {r} of {n}": (
        [sys.executable, str(script), *map(str, args_of(r))],
        dict(env, HVD_TPU_PROC_ID=str(r))) for r in range(n)}, timeout)
    return list(logs.values())


def session_world(tmp_path_factory, name: str, run) -> Path:
    """The directory ``run(directory)`` filled, once per test session
    however many xdist workers ask: the first caller runs it under an
    exclusive lock in the session's shared temporary directory (the
    workers' base directories' parent), the others wait on the lock and
    read what it wrote. A run that raised leaves no mark, so the next
    caller runs it again."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    out = root / f"world_{name}"
    with open(root / f"world_{name}.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            if not (out / "done").exists():
                out.mkdir(exist_ok=True)
                run(out)
                (out / "done").write_text("done\n")
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    return out


def test_session_world_runs_once(tmp_path_factory):
    """A second caller in the session reads the first one's directory; a
    run that raised is run again by the next caller."""
    calls = []

    def run(out):
        calls.append(out)
        (out / "value").write_text(str(len(calls)))

    name = f"probe{os.getpid()}"
    a = session_world(tmp_path_factory, name, run)
    b = session_world(tmp_path_factory, name, run)
    assert a == b and len(calls) == 1 and (b / "value").read_text() == "1"

    def broken(out):
        calls.append(out)
        raise RuntimeError("no world")

    try:
        session_world(tmp_path_factory, name + "x", broken)
    except RuntimeError:
        pass
    session_world(tmp_path_factory, name + "x", run)
    assert len(calls) == 3


def test_world_slot_is_exclusive_across_open_files(tmp_path):
    """A second holder (another open file, as another xdist worker has)
    cannot take the slot while the first holds it, and can after (on a
    lock file of its own: the session's slot is busy with real worlds)."""
    path = str(tmp_path / LOCK_NAME)
    taken = threading.Event()
    release = threading.Event()

    def holder():
        with world_slot(path):
            taken.set()
            release.wait(30)

    t = threading.Thread(target=holder)
    t.start()
    try:
        assert taken.wait(30)
        with open(path, "a") as f:
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                got = True
            except BlockingIOError:
                got = False
            assert not got
            release.set()
            t.join(30)
            assert not t.is_alive()
            fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            fcntl.flock(f, fcntl.LOCK_UN)
    finally:
        release.set()
        t.join(30)


def test_run_ranks_reports_the_failing_rank(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text("import os, sys\n"
                      "r = int(os.environ['HVD_TPU_PROC_ID'])\n"
                      "print('rank', r, 'of', os.environ['HVD_TPU_NUM_PROC'],"
                      " 'threads', os.environ['OMP_NUM_THREADS'])\n"
                      "sys.exit(3 if r == 1 else 0)\n")
    try:
        run_ranks(script, lambda r: (), 2, timeout=60)
    except AssertionError as e:
        assert "rank 1 of 2 failed" in str(e) and "threads 1" in str(e)
    else:
        raise AssertionError("a rank's failure was not reported")
    logs = run_ranks(script, lambda r: (), 1, timeout=60)
    assert logs == ["rank 0 of 1 threads 1\n"]
