"""Cross-request shared-prefix KV reuse — the port of
``horovod_tpu/serve/prefix.py``.

Production traffic repeats itself: the same system prompt heads most
requests, and a naive engine re-prefills it every admission. This
cache stores each fresh full prefill's single-slot cache as an EXACT
slot copy (``kvcache.export_slot(exact=True)``: every leaf a raw clone,
no codec, so no rounding and no kernel launch) keyed by a content hash
of the prompt tokens. On the next admission the engine looks up the
stored prompt sharing the LONGEST common prefix, forks it (import +
``rewind_slots`` to the common length — causal attention means a
token's KV depends only on the tokens before it, so the truncated lines
are the lines a fresh prefill of the prefix writes), and prefills only
the remainder.

Deterministic by construction: insertion order is the request order,
lookup ties break toward the earliest-inserted entry, and eviction is
FIFO under the ``HVD_TPU_SERVE_PREFIX_CAP`` entry bound — a seeded
replay hits and evicts identically, keeping the serve event-digest
contract.

The cache is SHARED cluster-wide (``make_engine_factory`` threads one
instance into every replica), which is what makes "common system
prompts prefill once" true across the pool, not per replica. A stored
blob's raw leaves are clones, so a later prefill into the engine's
reused scratch cache cannot change a stored entry.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ..common import metrics as metrics_lib
from ..common.config import runtime_env

_M_HITS = metrics_lib.counter(
    "hvd_tpu_serve_prefix_hits_total",
    "admissions that forked a stored shared prefix instead of "
    "prefilling it")
_M_SAVED = metrics_lib.counter(
    "hvd_tpu_serve_prefix_tokens_saved_total",
    "prompt tokens NOT prefilled thanks to shared-prefix forks — the "
    "prefix-reuse A/B's strictly-reduced prefill work")

DEFAULT_CAP = 8


def _content_hash(prompt: Sequence[int]) -> str:
    """Content hash of a token sequence — the cache key (dtype-pinned
    so the same tokens hash identically on every host)."""
    return hashlib.sha256(
        np.asarray(prompt, np.int32).tobytes()).hexdigest()


def prefix_cap_from_env() -> int:
    """``HVD_TPU_SERVE_PREFIX_CAP`` (registry-routed): max stored
    entries, 0 disables the cache entirely."""
    raw = runtime_env("SERVE_PREFIX_CAP")
    if not raw:
        return DEFAULT_CAP
    try:
        cap = int(raw)
    except ValueError:
        raise ValueError(
            f"HVD_TPU_SERVE_PREFIX_CAP={raw!r} must be an integer")
    if cap < 0:
        raise ValueError(
            f"HVD_TPU_SERVE_PREFIX_CAP must be >= 0, got {cap}")
    return cap


class PrefixCache:
    """Bounded, content-hashed store of prefilled prompt caches.

    ``insert(prompt, blob)`` stores a fresh full prefill (exact slot
    export); ``lookup(prompt)`` returns ``(common_len, blob)`` for the
    stored prompt with the longest common prefix — clamped to
    ``len(prompt) - 1`` so at least one remainder token prefills (the
    first output token's logits must be computed fresh)."""

    def __init__(self, cap: int = DEFAULT_CAP):
        self.cap = int(cap)
        # key -> (prompt tuple, blob); OrderedDict = FIFO eviction.
        self._entries: "OrderedDict[str, Tuple[Tuple[int, ...], Any]]" \
            = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0

    def __len__(self) -> int:
        return len(self._entries)

    def insert(self, prompt: Tuple[int, ...], blob: Dict) -> bool:
        """Store one fresh prefill; False when disabled, duplicate, or
        too short to ever fork (a 1-token prompt has no usable
        prefix)."""
        if self.cap <= 0 or len(prompt) < 2:
            return False
        key = _content_hash(prompt)
        if key in self._entries:
            return False
        while len(self._entries) >= self.cap:
            self._entries.popitem(last=False)
        self._entries[key] = (tuple(prompt), blob)
        return True

    def lookup(self, prompt: Sequence[int]
               ) -> Optional[Tuple[int, Any]]:
        """Longest-common-prefix match over the stored prompts
        (earliest-inserted entry wins a length tie — deterministic).
        Returns ``(common_len, blob)`` with ``1 <= common_len <
        len(prompt)``, or None."""
        prompt = list(prompt)
        best_len = 0
        best_blob = None
        limit = len(prompt) - 1
        for stored, blob in self._entries.values():
            n = 0
            for a, b in zip(stored, prompt):
                if a != b:
                    break
                n += 1
            n = min(n, limit)
            if n > best_len:
                best_len, best_blob = n, blob
        if best_len < 1:
            self.misses += 1
            return None
        return best_len, best_blob

    def note_hit(self, saved_tokens: int) -> None:
        """Called by the engine when a fork actually happened (the
        engine may still refuse a lookup result on a ring-wrap
        guard)."""
        self.hits += 1
        self.tokens_saved += int(saved_tokens)
        _M_HITS.inc()
        _M_SAVED.inc(saved_tokens)

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses,
                "tokens_saved": self.tokens_saved}
