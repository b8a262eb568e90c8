"""Seeded open-loop traffic for the serve bench/chaos surfaces
(docs/serve.md).

The port's copy of ``horovod_tpu/serve/traffic.py``: the same seed
gives the identical trace in both packages.

Open-loop (arrivals ignore the server's state) is the honest serving
benchmark shape: a closed loop self-throttles under overload and hides
queueing collapse. Arrivals are Poisson (exponential inter-arrival
times at ``rate_rps``), prompt/output lengths are drawn from mixed
seeded distributions — everything derives from ``numpy``'s
``default_rng(seed)``, so the same seed replays the byte-identical
request sequence (the chaos soak and the bench repeat-determinism
check both rely on this).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .queue import Request


@dataclasses.dataclass
class TrafficTrace:
    """A materialized request sequence (arrival-sorted)."""

    seed: int
    requests: List[Request]

    @property
    def duration_s(self) -> float:
        return self.requests[-1].arrival_t if self.requests else 0.0

    def __len__(self) -> int:
        return len(self.requests)


def poisson_trace(seed: int, n_requests: int, rate_rps: float,
                  prompt_lens: Sequence[int] = (4, 8, 16),
                  output_lens: Sequence[int] = (4, 8, 16, 32),
                  vocab_size: int = 128,
                  deadline_s: float = 0.0,
                  temperature: float = 0.0,
                  shared_prefix_len: int = 0,
                  class_mix: Optional[Sequence[Tuple[str, float]]]
                  = None,
                  class_deadlines: Optional[Dict[str, float]]
                  = None) -> TrafficTrace:
    """Seeded open-loop trace: Poisson arrivals at ``rate_rps``, prompt
    and output lengths drawn uniformly from the given mixes, prompt
    tokens uniform over ``[1, vocab_size)`` (0 is reserved for pad).
    ``deadline_s`` stamps every request with a latency budget.
    ``temperature`` > 0 stamps every request with that sampling
    temperature plus a seeded per-request ``sample_seed`` (drawn from
    this trace's own rng — the PRNG lane the engine folds with
    (rid, position)), so a sampled trace replays byte-identically under
    the same trace seed; 0 keeps the greedy default.
    ``shared_prefix_len`` > 0 prepends ONE seeded token sequence of
    that length to every prompt — the shared-system-prompt traffic
    shape the prefix-reuse arm measures (docs/serve.md); the drawn
    ``prompt_lens`` then size each request's unique tail.
    ``class_mix`` — mixed tenancy (docs/serve.md "Overload &
    tenancy"): ``[("latency", 0.5), ("throughput", 0.3), ...]`` stamps
    each request's ``slo_class``, drawn by weight from this trace's
    rng strictly AFTER every pre-existing draw, so a trace without a
    mix replays byte-identically to earlier releases.
    ``class_deadlines`` (name -> seconds) stamps per-class deadlines
    onto classed requests that the flat ``deadline_s`` did not —
    giving control-OFF baselines the same deadline accounting as
    control-ON runs."""
    if n_requests < 1 or rate_rps <= 0:
        raise ValueError(
            f"need n_requests >= 1 and rate_rps > 0, got "
            f"{n_requests}/{rate_rps}")
    rng = np.random.default_rng(seed)
    shared: Tuple[int, ...] = ()
    if shared_prefix_len > 0:
        shared = tuple(int(t) for t in rng.integers(
            1, vocab_size, int(shared_prefix_len)))
    gaps = rng.exponential(1.0 / rate_rps, size=n_requests)
    arrivals = np.cumsum(gaps)
    plens = rng.choice(np.asarray(prompt_lens), size=n_requests)
    olens = rng.choice(np.asarray(output_lens), size=n_requests)
    sseeds = (rng.integers(0, 2 ** 31 - 1, size=n_requests)
              if temperature > 0 else np.zeros(n_requests, np.int64))
    reqs = []
    for i in range(n_requests):
        prompt: Tuple[int, ...] = shared + tuple(
            int(t) for t in rng.integers(1, vocab_size, int(plens[i])))
        reqs.append(Request(
            rid=i, prompt=prompt, max_new_tokens=int(olens[i]),
            arrival_t=float(arrivals[i]), deadline_s=deadline_s,
            temperature=float(temperature),
            sample_seed=int(sseeds[i])))
    if class_mix:
        names = [str(n) for n, _ in class_mix]
        weights = np.asarray([float(w) for _, w in class_mix])
        if (weights < 0).any() or weights.sum() <= 0:
            raise ValueError(
                f"class_mix weights must be non-negative with a "
                f"positive sum, got {list(class_mix)}")
        # One extra draw block at the very end: pre-existing seeded
        # traces (no mix) consume the identical rng stream.
        picks = rng.choice(len(names), size=n_requests,
                           p=weights / weights.sum())
        deadlines = class_deadlines or {}
        for req, pick in zip(reqs, picks):
            req.slo_class = names[int(pick)]
            if req.deadline_s == 0:
                req.deadline_s = float(
                    deadlines.get(req.slo_class, 0.0))
    return TrafficTrace(seed=seed, requests=reqs)
