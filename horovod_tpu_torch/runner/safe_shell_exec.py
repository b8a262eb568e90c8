"""Worker processes under a pseudo-terminal with signal forwarding — the
port's copy of ``horovod_tpu/runner/safe_shell_exec.py``: each worker is
spawned (``subprocess``, a fresh interpreter: never a fork of a process
whose CUDA context is up) in its own process group, its output
line-buffered and prefixed by its slot, and SIGINT/SIGTERM on the
launcher go to the whole group, escalating to SIGKILL after a grace
period.
"""

from __future__ import annotations

import os
import pty
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

GRACEFUL_TERMINATION_TIME_S = 5.0


def _pump(fd: int, prefix: Optional[str], sink) -> None:
    buf = b""
    while True:
        try:
            chunk = os.read(fd, 4096)
        except OSError:  # pty slave closed
            chunk = b""
        if not chunk:
            if buf:
                _emit(buf, prefix, sink)
            return
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            _emit(line + b"\n", prefix, sink)


def _emit(line: bytes, prefix: Optional[str], sink) -> None:
    text = line.decode(errors="replace")
    if prefix is not None:
        text = f"[{prefix}]: {text}"
    sink.write(text)
    sink.flush()


class SpawnedProcess:
    """A worker under a pty with group-signal control — the handle the
    launcher's fail-fast waiter polls/terminates."""

    def __init__(self, proc: subprocess.Popen, thread: threading.Thread):
        self.proc = proc
        self.thread = thread

    def poll(self):
        return self.proc.poll()

    def wait(self):
        rc = self.proc.wait()
        self.thread.join(timeout=2)
        return rc

    def _signal_group(self, signum) -> None:
        try:
            os.killpg(os.getpgid(self.proc.pid), signum)
        except ProcessLookupError:
            pass

    def send_signal(self, signum) -> None:
        self._signal_group(signum)

    def terminate(self) -> None:
        """Group SIGTERM, escalating to SIGKILL after the grace window
        (reference safe_shell_exec GRACEFUL_TERMINATION_TIME_S)."""
        self._signal_group(signal.SIGTERM)

        def escalate():
            deadline = time.monotonic() + GRACEFUL_TERMINATION_TIME_S
            while time.monotonic() < deadline:
                if self.proc.poll() is not None:
                    return
                time.sleep(0.1)
            self._signal_group(signal.SIGKILL)

        threading.Thread(target=escalate, daemon=True).start()


def spawn(command: List[str], env: Optional[Dict[str, str]] = None,
          prefix: Optional[str] = None, use_pty: bool = True,
          sink=None, input_data: Optional[bytes] = None) -> SpawnedProcess:
    """Start ``command`` under a pseudo-terminal (children see a tty →
    line buffering, progress bars) in its own process group, with a pump
    thread prefixing output lines. Returns the control handle.
    ``input_data`` is written to the child's stdin then closed — the
    channel secrets travel on (they must never ride argv, which any
    local user can read via ps)."""
    sink = sink or sys.stdout
    stdin = subprocess.PIPE if input_data is not None else None
    if use_pty:
        try:
            master, slave = pty.openpty()
        except OSError:  # no pty available (containers without devpts)
            use_pty = False
    if use_pty:
        proc = subprocess.Popen(command, env=env, stdin=stdin,
                                stdout=slave,
                                stderr=slave, start_new_session=True)
        os.close(slave)
        fd = master
    else:
        proc = subprocess.Popen(command, env=env, stdin=stdin,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        fd = proc.stdout.fileno()
    if input_data is not None:
        proc.stdin.write(input_data)
        proc.stdin.close()

    def pump_and_close():
        try:
            _pump(fd, prefix, sink)
        finally:
            if use_pty:
                try:
                    os.close(master)
                except OSError:
                    pass

    t = threading.Thread(target=pump_and_close, daemon=True)
    t.start()
    return SpawnedProcess(proc, t)


def execute(command: List[str], env: Optional[Dict[str, str]] = None,
            prefix: Optional[str] = None, use_pty: bool = True,
            forward_signals: bool = True, sink=None) -> int:
    """Run ``command`` to completion; returns its exit code.

    * ``use_pty``: attach stdout/stderr to a pseudo-terminal;
    * ``forward_signals``: SIGINT/SIGTERM received by the caller are
      forwarded to the child's process group, escalating to SIGKILL
      after GRACEFUL_TERMINATION_TIME_S (reference safe_shell_exec
      forward_signals semantics).
    """
    handle = spawn(command, env=env, prefix=prefix, use_pty=use_pty,
                   sink=sink)
    old_handlers = {}

    def forward(signum, _frame):
        handle.send_signal(signum)
        if signum in (signal.SIGINT, signal.SIGTERM):
            handle.terminate()

    if forward_signals and threading.current_thread() is \
            threading.main_thread():
        for sig in (signal.SIGINT, signal.SIGTERM):
            old_handlers[sig] = signal.signal(sig, forward)
    try:
        return handle.wait()
    finally:
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)
