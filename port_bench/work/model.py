"""Model FLOPs of one training step of a transformer from its widths:
``6 x`` the non-embedding matmul parameters ``x`` the positions fed, plus the
tied head's ``6 * hidden * vocab`` for each position whose logits the loss
reads (every position, or a masked-LM batch's targets), plus ``3 x``
attention's forward FLOPs (:mod:`.attention`). Only the work the inputs
need is counted: not the head over positions the loss ignores, nor
recompute."""

from __future__ import annotations

from typing import Optional, Sequence

from . import attention


def matmul_params(layers: int, hidden: int, mlp: int) -> int:
    """Weights of the fused QKV, the output projection and the two MLP
    matmuls of every layer (no biases, no embeddings)."""
    return layers * (4 * hidden * hidden + 2 * hidden * mlp)


def train_flops(layers: int, hidden: int, heads: int, mlp: int, vocab: int,
                rows: int, seq: int, causal: bool,
                lengths: Optional[Sequence[int]] = None,
                targets: Optional[int] = None) -> float:
    positions = rows * seq
    head_dim = hidden // heads
    attn_fwd = 4 * attention.pairs(rows, seq, heads, causal, lengths) \
        * head_dim
    read = positions if targets is None else targets
    return (6 * matmul_params(layers, hidden, mlp) * positions
            + 6 * hidden * vocab * read
            + 3 * attn_fwd * layers)
