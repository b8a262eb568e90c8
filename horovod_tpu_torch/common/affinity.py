"""Thread/core affinity pinning — the port's copy of
``horovod_tpu/common/affinity.py`` (reference Horovod's
``parse_and_set_affinity``): ``HVD_TPU_THREAD_AFFINITY`` holds one core
id per local rank, comma-separated; rank ``local_rank`` pins to its id.

The GPU does the math, but the host feeds it: the input pipeline, the
D2 worker thread and gloo's host copies compete for cores, and the
processes of one host otherwise migrate onto each other's cores.
Pinning the PROCESS (``os.sched_setaffinity(0, ...)``) covers every
thread it spawns afterwards.

A malformed spec LOGS an error and leaves affinity untouched: a bad
environment variable must never kill a training job.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

logger = logging.getLogger("horovod_tpu_torch")


def parse_affinity(spec: str, local_size: int) -> Optional[List[int]]:
    """``"0,4,8,12"`` -> [0, 4, 8, 12]; None (+ error log) on any of the
    rejection cases: non-numeric, negative, or fewer ids than
    ``local_size``."""
    ids: List[int] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            core = int(part)
        except ValueError:
            logger.error("No digits were found in thread-affinity "
                         "spec %r", spec)
            return None
        if core < 0:
            logger.error("Core ID cannot be less than zero but got %d "
                         "in %r", core, spec)
            return None
        ids.append(core)
    if len(ids) < local_size:
        logger.error("Expected %d core ids but got %d in %r",
                     local_size, len(ids), spec)
        return None
    return ids


def set_affinity(core_id: int) -> bool:
    """Pin this process (and its future threads) to ``core_id``."""
    if not hasattr(os, "sched_setaffinity"):  # non-Linux host
        logger.error("sched_setaffinity unavailable on this platform; "
                     "thread affinity ignored")
        return False
    try:
        os.sched_setaffinity(0, {core_id})
        logger.info("pinned process to core %d", core_id)
        return True
    except OSError as e:
        logger.error("failed to set affinity to core %d: %s", core_id, e)
        return False


def parse_and_set_affinity(spec: Optional[str], local_size: int,
                           local_rank: int) -> bool:
    """The entry point ``init()`` calls: no-op on an empty spec; parse;
    pin this rank's core. Returns True iff a pin happened."""
    if not spec:
        return False
    ids = parse_affinity(spec, max(local_size, local_rank + 1))
    if ids is None:
        return False
    return set_affinity(ids[local_rank])
