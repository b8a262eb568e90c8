"""The work of one attention call (forward, or forward and backward) from
its shapes, for the roofline of the flash kernels K5, K6 and K7.

Counted as the inputs need it, not as the kernels do it:

* ``pairs``: the (query, key) pairs the inputs need: at or below the
  diagonal when causal, the valid keys only under a key mask (every query
  row of a masked batch still attends);
* FLOPs: forward ``4 * pairs * d`` (QK^T and PV), backward ``8 * pairs * d``
  (dV, dP, dQ, dK), without the backward's recompute of the scores;
* bytes: q, k, v, o, do, dq, dk and dv in bf16 once each, the fp32
  log-sum-exp once, and the fp32 key mask once.
"""

from __future__ import annotations

from typing import Optional, Sequence

BF16 = 2
FP32 = 4


def pairs(rows: int, seq: int, heads: int, causal: bool,
          lengths: Optional[Sequence[int]] = None) -> int:
    """Needed (query, key) pairs over all rows and heads."""
    if causal and lengths is not None:
        raise ValueError("a causal call with a key mask is not counted here")
    if causal:
        return rows * heads * seq * (seq + 1) // 2
    if lengths is None:
        return rows * heads * seq * seq
    if len(lengths) != rows:
        raise ValueError(f"{len(lengths)} lengths for {rows} rows")
    return heads * seq * sum(min(int(n), seq) for n in lengths)


def train_work(rows: int, seq: int, heads: int, head_dim: int,
               causal: bool, lengths: Optional[Sequence[int]] = None
               ) -> dict:
    """FLOPs and bytes of one forward and backward attention call."""
    p = pairs(rows, seq, heads, causal, lengths)
    x = rows * seq * heads * head_dim * BF16
    lse = rows * heads * seq * FP32
    mask = 0 if lengths is None else rows * seq * FP32
    return {"pairs": p,
            "flops": 4 * p * head_dim + 8 * p * head_dim,
            "bytes": 8 * x + lse + mask}


def least_seconds(work: dict, peaks: dict) -> dict:
    """The least time the card could take: the larger of FLOPs over the
    bf16 peak and bytes over the HBM peak, and which of the two binds."""
    compute = work["flops"] / peaks["bf16_flops_per_s"]
    memory = work["bytes"] / peaks["hbm_bytes_per_s"]
    return {"seconds": max(compute, memory),
            "bound": "compute" if compute >= memory else "memory"}
