"""LSF host detection, the port's copy of ``horovod_tpu/runner/lsf.py``.

Inside an LSF allocation the scheduler already owns the host set
(Horovod's ``LSFUtils``): ``hvdtpurun-torch`` with no ``-H`` or
``--hostfile`` takes the hosts from ``LSB_DJOB_HOSTFILE`` (one hostname a
slot, one a line), else ``LSB_MCPU_HOSTS`` (``"h1 n1 h2 n2 ..."``), else
``LSB_HOSTS`` (``"h1 h1 h2 ..."``), and fans out over ssh. There is no
``jsrun`` to exec."""

from __future__ import annotations

import collections
import os
from typing import List

from . import hosts as hosts_lib


def in_lsf() -> bool:
    """True inside an LSF job allocation (reference lsf.py using
    LSB_JOBID presence)."""
    return "LSB_JOBID" in os.environ


def lsf_hosts() -> List[hosts_lib.HostInfo]:
    """Host list with slot counts from the LSF environment.

    Precedence mirrors the reference: LSB_DJOB_HOSTFILE (one hostname
    per slot, one per line) > LSB_MCPU_HOSTS ("h1 n1 h2 n2 ...") >
    LSB_HOSTS ("h1 h1 h2 ...")."""
    hostfile = os.environ.get("LSB_DJOB_HOSTFILE")
    if hostfile and os.path.exists(hostfile):
        counts: "collections.OrderedDict[str, int]" = \
            collections.OrderedDict()
        with open(hostfile) as f:
            for line in f:
                name = line.strip()
                if name:
                    counts[name] = counts.get(name, 0) + 1
        return [hosts_lib.HostInfo(h, n) for h, n in counts.items()]

    mcpu = os.environ.get("LSB_MCPU_HOSTS")
    if mcpu:
        parts = mcpu.split()
        return [hosts_lib.HostInfo(parts[i], int(parts[i + 1]))
                for i in range(0, len(parts) - 1, 2)]

    hosts = os.environ.get("LSB_HOSTS")
    if hosts:
        counts = collections.OrderedDict()
        for name in hosts.split():
            counts[name] = counts.get(name, 0) + 1
        return [hosts_lib.HostInfo(h, n) for h, n in counts.items()]

    raise RuntimeError(
        "inside an LSF job (LSB_JOBID set) but no host environment "
        "found (LSB_DJOB_HOSTFILE / LSB_MCPU_HOSTS / LSB_HOSTS)")
