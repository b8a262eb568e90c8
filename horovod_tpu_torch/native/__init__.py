"""The controller's bookkeeping tables — the port of the Python paths of
``horovod_tpu/native/__init__.py``.

The JAX package backs these with a C++ library (``native/*.cc``, host
code, not a TPU kernel) and falls back to the Python behaviour kept
here: :class:`NegotiationTable`, rank 0's record of which ranks reported
a round, and :class:`ResponseCacheNative`, the bounded LRU of the eager
engine's signature cache (an ``OrderedDict``, most recent last). The C++
copy is later work of the port.
"""

from __future__ import annotations

import collections
import threading
from typing import List, Optional


class NegotiationTable:
    """Which ranks reported each pending round (the reference's
    IncrementTensorCount table)."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._pending: dict = {}
        self._lock = threading.Lock()

    def increment(self, name: str, rank: int) -> int:
        """1 = the round just became complete (every rank in), 0 =
        pending, -1 = a duplicate or out-of-range rank."""
        with self._lock:
            if not 0 <= rank < self.world_size:
                return -1
            ranks = self._pending.setdefault(name, set())
            if rank in ranks:
                return -1
            ranks.add(rank)
            if len(ranks) == self.world_size:
                del self._pending[name]
                return 1
            return 0

    def missing_ranks(self, name: str) -> Optional[List[int]]:
        """Ranks that have not reported ``name`` yet; None when the name
        is unknown or complete."""
        with self._lock:
            if name not in self._pending:
                return None
            got = self._pending[name]
            return [r for r in range(self.world_size) if r not in got]


class ResponseCacheNative:
    """Bounded LRU of signature strings."""

    def __init__(self, capacity: int):
        self.capacity = max(int(capacity), 1)
        self._od: "collections.OrderedDict[str, bool]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def lookup(self, key: str) -> bool:
        """True (and the key becomes the most recent) when cached."""
        with self._lock:
            if key in self._od:
                self._od.move_to_end(key)
                return True
            return False

    def put(self, key: str) -> Optional[str]:
        """Insert; returns the evicted key when capacity forced one
        out."""
        with self._lock:
            if key in self._od:
                self._od.move_to_end(key)
                return None
            self._od[key] = True
            if len(self._od) > self.capacity:
                victim, _ = self._od.popitem(last=False)
                return victim
            return None

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)
