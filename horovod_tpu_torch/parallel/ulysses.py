"""Ulysses-style sequence parallelism — all-to-all head scatter; the port
of ``horovod_tpu/parallel/ulysses.py``.

With the sequence sharded over the ``sp`` axis and H heads:

  1. an all-to-all turns (B, S/n, H, D) into (B, S, H/n, D): every rank
     gathers the FULL sequence for 1/n of the heads;
  2. any attention runs on that head subset unchanged (the causal flash
     kernels K5-K7 in the GPT);
  3. the inverse all-to-all restores (B, S/n, H, D).

Each scatter rides the sequence wire through
``collectives._a2a_exchange`` (``none``, ``bf16``, or ``int8``
block-scaled with a straight-through gradient); the backward of an
all-to-all is the inverse all-to-all. Bytes go to
``collectives.count_seq_kv_bytes``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops import collectives as C


def _a2a_wired(x: torch.Tensor, ax, split_axis: int, concat_axis: int,
               wire: str, key=None) -> torch.Tensor:
    """The tiled all-to-all of ``x`` over ``ax``: dim ``split_axis``
    splits into ``n`` chunks, chunk ``j`` goes to rank ``j``, and the
    received chunks concatenate along ``concat_axis`` in source order
    (``lax.all_to_all(..., tiled=True)``), in ``wire``."""
    n = ax.size
    if n == 1:
        return x
    s, c = split_axis, concat_axis
    k = x.shape[s] // n
    xs = torch.movedim(
        x.reshape(tuple(x.shape[:s]) + (n, k) + tuple(x.shape[s + 1:])),
        s, 0)
    lead = xs.shape
    got = C._a2a_exchange(xs.reshape(n, -1), ax, wire, key).reshape(lead)
    out = torch.movedim(got, 0, c)
    return out.reshape(tuple(out.shape[:c]) + (n * out.shape[c + 1],)
                       + tuple(out.shape[c + 2:]))


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis="sp", attend_fn: Optional[Callable] = None,
                      mask=None, wire: Optional[str] = None,
                      wire_key=None) -> torch.Tensor:
    """Attention over sequence-sharded q/k/v ``(B, S_local, H, D)`` by
    head scatter; H must divide over the axis. ``attend_fn(q, k, v,
    mask)`` sees full-sequence ``(B, S, H/n, D)`` inputs (default: the
    non-causal flash attention). ``wire`` (None: the configured sequence
    wire) rounds once per scatter, four a call; ``wire_key`` makes int8
    rounding stochastic (folded per scatter)."""
    from .ring_attention import resolve_seq_wire

    wire = resolve_seq_wire(wire)
    ax = C._axis(axis)
    n = ax.size
    h = q.shape[2]
    if h % n:
        raise ValueError(f"num heads {h} not divisible by sp size {n}")
    if attend_fn is None:
        from ..ops.flash_attention import attend as attend_fn

    def kk(j):
        return None if wire_key is None else C.fold_in(wire_key, j)

    # 4 scatters (q, k, v out, o back), each keeping (n-1)/n of its
    # buffer on the wire.
    tot = 2 * q.numel() + k.numel() + v.numel()
    C.count_seq_kv_bytes(ax.name, wire, tot // n, n, q.element_size(),
                         n - 1)
    qg = _a2a_wired(q, ax, 2, 1, wire, kk(0))
    kg = _a2a_wired(k, ax, 2, 1, wire, kk(1))
    vg = _a2a_wired(v, ax, 2, 1, wire, kk(2))
    og = attend_fn(qg, kg, vg, mask)
    return _a2a_wired(og, ax, 1, 2, wire, kk(3))


def ulysses_attend_fn(axis="sp", inner: Optional[Callable] = None,
                      wire: Optional[str] = None, wire_key=None
                      ) -> Callable:
    """An ``attend_fn`` running :func:`ulysses_attention` with ``inner``
    as the full-sequence attention."""

    def attend(q, k, v, mask=None):
        return ulysses_attention(q, k, v, axis, inner, mask, wire=wire,
                                 wire_key=wire_key)

    return attend
