"""Host lists and slot assignment of the port's launcher — its copy of
``horovod_tpu/runner/hosts.py``: ``-H host1:4,host2:4`` or a hostfile of
``hostname slots=N`` lines; ranks are assigned host-major, so a host's
local ranks are contiguous (one GPU a slot).
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional


@dataclasses.dataclass
class HostInfo:
    hostname: str
    slots: int


@dataclasses.dataclass
class SlotInfo:
    hostname: str
    rank: int
    local_rank: int
    cross_rank: int
    size: int
    local_size: int
    cross_size: int


def parse_hosts(hosts_string: str) -> List[HostInfo]:
    """'h1:4,h2:4' -> [HostInfo]. A bare 'h1' means 1 slot."""
    out = []
    for part in hosts_string.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            name, slots = part.rsplit(":", 1)
            out.append(HostInfo(name, int(slots)))
        else:
            out.append(HostInfo(part, 1))
    return out


def parse_host_files(filename: str) -> List[HostInfo]:
    """Hostfile lines: 'hostname slots=N' (reference hosts.py:66-86)."""
    out = []
    with open(filename) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            m = re.match(r"^(\S+)(?:\s+slots\s*=\s*(\d+))?", line)
            if m:
                out.append(HostInfo(m.group(1), int(m.group(2) or 1)))
    return out


def get_host_assignments(hosts: List[HostInfo], np: int,
                         min_np: Optional[int] = None) -> List[SlotInfo]:
    """Assign np ranks over hosts host-major (reference hosts.py:100-155)."""
    total = sum(h.slots for h in hosts)
    if np > total:
        raise ValueError(
            f"requested {np} processes but hosts provide only {total} slots")
    if min_np is not None and total < min_np:
        raise ValueError(f"fewer than min_np={min_np} slots available")

    assignments: List[SlotInfo] = []
    rank = 0
    used_hosts = []
    for cross_rank, h in enumerate(hosts):
        if rank >= np:
            break
        use = min(h.slots, np - rank)
        used_hosts.append((h, use))
        for local in range(use):
            assignments.append(SlotInfo(
                hostname=h.hostname, rank=rank, local_rank=local,
                cross_rank=cross_rank, size=np, local_size=use,
                cross_size=0))
            rank += 1
    cross_size = len(used_hosts)
    for s in assignments:
        s.cross_size = cross_size
    return assignments
