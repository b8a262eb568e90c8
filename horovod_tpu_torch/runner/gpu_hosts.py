"""GPU host discovery for the launcher, the counterpart of the JAX
launcher's ``runner/tpu_pod.py``.

A TPU pod publishes its whole topology to every worker VM through
environment metadata, which ``tpu_pod`` reads. A GPU machine publishes
no cluster; what the launcher can know without probing anything is how
many GPUs this machine has: the entries of ``CUDA_VISIBLE_DEVICES`` when
it is set, else the ``GPU`` lines of ``nvidia-smi -L``. CUDA is never
initialized here (the launcher must not hold a context on a card its
workers use). With ``-np`` unset and no hosts, a local launch runs one
worker per GPU; no GPU found, or a value that does not parse, leaves the
launch as it was (``-np 1``). Nothing else: no remote probing.
"""

from __future__ import annotations

import os
import subprocess
from typing import Mapping, Optional


def count_visible(value: str) -> Optional[int]:
    """The devices ``CUDA_VISIBLE_DEVICES=value`` leaves visible: its
    entries up to the first negative index (CUDA hides that one and all
    after it), each a non-negative index or a ``GPU-``/``MIG-`` UUID;
    ``""`` and ``"-1"`` give 0. None for any other entry (malformed)."""
    n = 0
    for entry in value.split(","):
        entry = entry.strip()
        if not entry:
            if value.strip():
                return None
            break
        if entry.startswith(("GPU-", "MIG-")):
            n += 1
            continue
        try:
            index = int(entry)
        except ValueError:
            return None
        if index < 0:
            break
        n += 1
    return n


def count_smi_lines(text: str) -> int:
    """The GPUs of an ``nvidia-smi -L`` listing (``GPU <i>: <name> (UUID:
    ...)`` lines; MIG lines below a GPU are not GPUs)."""
    return sum(1 for line in text.splitlines() if line.startswith("GPU "))


def _nvidia_smi_list() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout if out.returncode == 0 else None


def local_gpu_count(environ: Optional[Mapping[str, str]] = None,
                    smi_output: Optional[str] = None) -> Optional[int]:
    """The GPUs of this machine, or None when none is found or the
    environment does not parse: ``CUDA_VISIBLE_DEVICES`` when set, else
    ``nvidia-smi -L`` (``smi_output`` stands for its output)."""
    environ = os.environ if environ is None else environ
    value = environ.get("CUDA_VISIBLE_DEVICES")
    if value is not None:
        n = count_visible(value)
    else:
        text = _nvidia_smi_list() if smi_output is None else smi_output
        n = None if text is None else count_smi_lines(text)
    return n or None
