"""Tensor parallelism — Megatron-style column/row-parallel layers; the
port of ``horovod_tpu/parallel/tensor_parallel.py``.

The canonical transformer pairing, one allreduce a block:

  column-parallel W1 (out-features sharded, no communication)
      -> the nonlinearity on the local shard
  row-parallel W2 (in-features sharded, SUM of the partial outputs)

Weights keep the JAX layout ``(in, out)`` (``x @ w``). Each function
takes ``axis``, an :class:`~..common.topology.Axis` or a mesh axis name
(``"tp"`` after ``init(parallel=...)``), where the JAX function takes an
``axis_name`` bound by ``shard_map``.

The gradient semantics are the JAX package's per-rank ones: every tp
rank computes the whole loss, and the row-parallel SUM's backward is the
SUM of the cotangents (``collectives.tp_allreduce``), so a slice
gradient arrives multiplied by the tp size and a replicated parameter's
gradient holds only this rank's slice of the attention/MLP path. The
pmean of :func:`combine_slice_grads` — which
``DistributedOptimizer(parallel=)`` applies to every gradient over
``tp`` (then ``sp``) before the dp reduction — assembles the dense
gradient of every parameter, sliced or replicated.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Union

import torch
import torch.nn.functional as F

from ..ops import collectives as C


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def column_parallel(x: torch.Tensor, w_shard: torch.Tensor,
                    b_shard: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y_shard = x @ W[:, shard] (+ b[shard])`` — out-features sharded,
    the input replicated; no communication."""
    y = x @ w_shard
    if b_shard is not None:
        y = y + b_shard
    return y


def row_parallel(x_shard: torch.Tensor, w_shard: torch.Tensor,
                 axis="tp", b: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """``y = SUM_tp(x[shard] @ W[shard, :]) (+ b)`` — in-features
    sharded; one allreduce gives the replicated output."""
    y = C.tp_allreduce(x_shard @ w_shard, axis)
    if b is not None:
        y = y + b
    return y


def tp_mlp(x: torch.Tensor, w1_shard: torch.Tensor, b1_shard: torch.Tensor,
           w2_shard: torch.Tensor, b2: torch.Tensor, axis="tp",
           activation: Callable = _gelu) -> torch.Tensor:
    """Column-parallel in, row-parallel out: one allreduce for the whole
    MLP."""
    h = activation(column_parallel(x, w1_shard, b1_shard))
    return row_parallel(h, w2_shard, axis, b2)


def shard_column(w: torch.Tensor, axis="tp") -> torch.Tensor:
    """This rank's out-feature shard of a replicated ``(..., out)``
    weight (a view; its gradient lands in the slice)."""
    ax = C._axis(axis)
    if w.shape[-1] % ax.size:
        raise ValueError(f"out dim {w.shape[-1]} not divisible by tp "
                         f"size {ax.size} (a silent truncation would drop "
                         "features)")
    chunk = w.shape[-1] // ax.size
    return w.narrow(w.dim() - 1, ax.index * chunk, chunk)


def shard_row(w: torch.Tensor, axis="tp") -> torch.Tensor:
    """This rank's in-feature shard of a replicated ``(in, out)``
    weight."""
    ax = C._axis(axis)
    if w.shape[0] % ax.size:
        raise ValueError(f"in dim {w.shape[0]} not divisible by tp size "
                         f"{ax.size}")
    chunk = w.shape[0] // ax.size
    return w.narrow(0, ax.index * chunk, chunk)


def shard_heads(w: torch.Tensor, num_heads: int, axis="tp",
                fused: int = 1) -> torch.Tensor:
    """The HEAD slice of an attention projection ``(..., fused *
    num_heads * head_dim)`` whose last dim is ``fused`` consecutive
    blocks of ``num_heads`` heads (the fused QKV kernel ``(h, 3h)``,
    ``[q|k|v]``, with ``fused=3``): this rank's ``(..., fused,
    heads_local, head_dim)``."""
    ax = C._axis(axis)
    if num_heads % ax.size:
        raise ValueError(f"num_heads {num_heads} not divisible by tp size "
                         f"{ax.size} (a silent truncation would drop "
                         "heads)")
    if w.shape[-1] % (fused * num_heads):
        raise ValueError(
            f"last dim {w.shape[-1]} does not factor as fused={fused} x "
            f"num_heads={num_heads} x head_dim")
    hl = num_heads // ax.size
    hd = w.shape[-1] // (fused * num_heads)
    wr = w.reshape(tuple(w.shape[:-1]) + (fused, num_heads, hd))
    return wr.narrow(wr.dim() - 2, ax.index * hl, hl)


def shard_head_rows(w: torch.Tensor, num_heads: int, axis="tp"
                    ) -> torch.Tensor:
    """The head-major INPUT rows ``(num_heads * head_dim, out)`` of an
    attention output projection, this rank's ``(heads_local * head_dim,
    out)`` — the row-parallel partner of :func:`shard_heads`."""
    ax = C._axis(axis)
    if num_heads % ax.size:
        raise ValueError(f"num_heads {num_heads} not divisible by tp size "
                         f"{ax.size}")
    if w.shape[0] % num_heads:
        raise ValueError(f"in dim {w.shape[0]} does not factor into "
                         f"{num_heads} heads")
    hl = num_heads // ax.size
    hd = w.shape[0] // num_heads
    return w.narrow(0, ax.index * hl * hd, hl * hd)


def combine_slice_grads(grads: Union[torch.Tensor, Iterable, Dict],
                        axis="tp"):
    """pmean over ``axis`` of each gradient (a tensor, a sequence or a
    dict of them): assembles the disjoint slice gradients, cancels the
    tp factor the row-parallel transpose put on them, and averages the
    per-shard gradients of sequence-parallel ranks. Returns new
    tensors."""
    ax = C._axis(axis)

    def one(g):
        return C.allreduce(g, C.Average, axis=ax) if ax.size > 1 \
            else g.clone()

    if isinstance(grads, torch.Tensor):
        return one(grads)
    if isinstance(grads, dict):
        return {k: one(v) for k, v in grads.items()}
    return [one(g) for g in grads]


def tp_attention_qkv(x: torch.Tensor, wq_shard: torch.Tensor,
                     wk_shard: torch.Tensor, wv_shard: torch.Tensor,
                     num_heads_local: int):
    """Column-parallel QKV: each rank projects its head subset,
    ``(B, S, heads_local, head_dim)`` each; pair with a row-parallel
    output projection."""
    b, s, _ = x.shape

    def split(w):
        return (x @ w).reshape(b, s, num_heads_local, -1)

    return split(wq_shard), split(wk_shard), split(wv_shard)
