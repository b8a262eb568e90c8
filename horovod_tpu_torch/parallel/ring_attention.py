"""Ring attention — sequence parallelism over a permutation ring; the port
of ``horovod_tpu/parallel/ring_attention.py``.

Q/K/V are sharded along the sequence over the ``sp`` axis. Each rank
attends its local Q block against K/V blocks that rotate around the ring
through ``collectives.wired_ppermute`` (one neighbour hop a step), and
the blocks merge with an online softmax in fp32, so the full S x S score
matrix never exists.

Two forms, chosen by ``use_flash``:

* the flash form: each block goes through ``flash_attention_with_lse``
  (K5 forward, K6/K7 backward with the ``lse`` cotangent) and the
  normalized partials merge through :func:`_combine_partial`. A CUDA
  tensor always takes it (``use_flash=None``), launching the kernels or
  raising;
* the plain online-softmax form (:func:`_block_attend`), the CPU path and
  the oracle; on the card only when the caller passes
  ``use_flash=False``.

Every K/V hop rides the sequence wire: ``"none"`` the native dtype,
``"bf16"`` a cast around the hop, ``"int8"`` block-scaled codes (K2, K3
with a ``wire_key``) and fp32 scales with a straight-through gradient.
The wire defaults from ``init(seq_wire=)`` / ``HVD_TPU_SEQ_WIRE``. A
ring of n ranks makes n - 1 hops (the JAX loop's n-th hop only returns
each block to its owner); their bytes go to
``collectives.count_seq_kv_bytes``.

Matches the blockwise ring formulation of Liu et al. (Ring Attention,
2023) and, for causal models, the striped layout of Brandon et al.
(2023).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import collectives as C
# The numerics oracle, re-exported as the JAX module does.
from ..ops.flash_attention import (flash_attention_with_lse,  # noqa: F401
                                   reference_attention)

NEG_INF = -1e30


def resolve_seq_wire(explicit: Optional[str] = None) -> str:
    """None -> the configured default (``init(seq_wire=)``, else
    ``HVD_TPU_SEQ_WIRE``, else ``"none"``); an explicit value wins. One
    knob for the ring and the Ulysses exchanges."""
    if explicit is not None:
        return explicit
    from ..common import basics

    if basics.is_initialized():
        return basics.context().config.seq_wire or "none"
    from ..common.config import runtime_env

    return runtime_env("SEQ_WIRE") or "none"


def _seq_hop(x: torch.Tensor, ax, perm, wire: str, key, salt: int
             ) -> torch.Tensor:
    """One K/V ring hop in the sequence wire (``key`` folded by the hop's
    salt for stochastic int8 rounding)."""
    kk = None if key is None or wire != "int8" else C.fold_in(key, salt)
    return C.wired_ppermute(x, ax, perm, wire=wire, key=kk)


def _ring_perm(n: int):
    return [(j, (j + 1) % n) for j in range(n)]


def _use_flash(q: torch.Tensor, use_flash: Optional[bool]) -> bool:
    """The form a call takes: the kernels for a CUDA tensor unless the
    caller passes ``use_flash=False``; the plain blocks on the CPU unless
    the caller passes ``use_flash=True`` (then the kernels' plain
    versions)."""
    if use_flash is not None:
        return bool(use_flash)
    return q.device.type != "cpu"


def _block_attend(q, k, v, m, l, o, mask=None):
    """One online-softmax accumulation step. q (B, Sq, H, D); k/v (B, Sk,
    H, D); m, l (B, H, Sq) fp32 running max and denominator; o (B, Sq, H,
    D) fp32 running numerator."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    scores = scores / torch.sqrt(torch.tensor(d, dtype=torch.float32,
                                              device=q.device))
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.full_like(scores, NEG_INF))
    m_new = torch.maximum(m, scores.amax(dim=-1))
    correction = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l_new = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    o_new = o * correction.transpose(1, 2)[..., None] + pv.to(torch.float32)
    return m_new, l_new, o_new


def _finish(o: torch.Tensor, l: torch.Tensor, dtype) -> torch.Tensor:
    denom = l.transpose(1, 2)[..., None]
    return (o / torch.clamp(denom, min=1e-30)).to(dtype)


def _flash_block(q, k, v, mask, causal):
    """One block through the flash kernels -> ``(o fp32, lse)``."""
    out = flash_attention_with_lse(q, k, v, mask=mask, causal=causal)
    if out is None:
        raise RuntimeError(
            "ring attention: use_flash=True but flash attention is turned "
            "off (HVD_TPU_FLASH_ATTENTION=0)")
    o_i, lse_i = out
    return o_i.to(torch.float32), lse_i


def _combine_partial(o, lse, o_i, lse_i):
    """Logsumexp-weighted merge of a normalized partial ``(o_i, lse_i)``
    into the running ``(o, lse)``: a partial whose lse is -1e30 below the
    running one gets weight exactly 0, forward and backward."""
    lse_new = torch.logaddexp(lse, lse_i)
    w_old = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_i - lse_new).transpose(1, 2)[..., None]
    return o * w_old + o_i * w_new, lse_new


def _empty_partial(q: torch.Tensor):
    b, s, h, d = q.shape
    return (torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device),
            torch.full((b, h, s), NEG_INF, dtype=torch.float32,
                       device=q.device))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis="sp", causal: bool = False,
                   mask: Optional[torch.Tensor] = None,
                   use_flash: Optional[bool] = None,
                   wire: Optional[str] = None, wire_key=None
                   ) -> torch.Tensor:
    """Attention over sequence-sharded q/k/v, each ``(B, S_local, H, D)``
    — this rank's contiguous block of the ring ``axis``.

    ``causal`` masks over GLOBAL positions; ``mask`` is an optional
    ``(B, S_local)`` key mask of the local shard (1 = attend) that
    rotates around the ring with its K/V block (at its own dtype).
    Returns this rank's ``(B, S_local, H, D)`` output in q's dtype."""
    wire = resolve_seq_wire(wire)
    ax = C._axis(axis)
    n, idx = ax.size, ax.index
    b, s, h, d = q.shape
    perm = _ring_perm(n)
    has_mask = mask is not None
    m_cur = mask.to(torch.float32) if has_mask else None
    C.count_seq_kv_bytes(ax.name, wire, k.numel() + v.numel(), n,
                         k.element_size(), n - 1)
    flash = _use_flash(q, use_flash)
    if flash:
        o, lse = _empty_partial(q)
    else:
        m = torch.full((b, h, s), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
        o = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
        q_pos = idx * s + torch.arange(s, device=q.device)
    k_cur, v_cur = k, v
    for i in range(n):
        src = (idx - i) % n
        if flash:
            if not causal or src < idx:
                o_i, lse_i = _flash_block(q, k_cur, v_cur, m_cur, False)
            elif src == idx:
                o_i, lse_i = _flash_block(q, k_cur, v_cur, m_cur, True)
            else:
                # A later block: nothing visible, the JAX body's zero
                # partial at lse -1e30. Its zero-weight use of the block
                # keeps the hops' backward on this rank's tape: every
                # rank must send the inverse hops' cotangents in step.
                o_i, lse_i = _empty_partial(q)
                if k_cur.requires_grad or v_cur.requires_grad:
                    o_i = o_i + 0.0 * (k_cur.sum() + v_cur.sum())
            o, lse = _combine_partial(o, lse, o_i, lse_i)
        else:
            blk = None
            if has_mask:
                blk = m_cur[:, None, None, :] > 0
            if causal:
                k_pos = src * s + torch.arange(s, device=q.device)
                cmask = (q_pos[:, None] >= k_pos[None, :])[None, None]
                blk = cmask if blk is None else blk & cmask
            m, l, o = _block_attend(q, k_cur, v_cur, m, l, o, blk)
        if i < n - 1:
            k_cur = _seq_hop(k_cur, ax, perm, wire, wire_key, 2 * i)
            v_cur = _seq_hop(v_cur, ax, perm, wire, wire_key, 2 * i + 1)
            if has_mask:
                m_cur = C.wired_ppermute(m_cur, ax, perm)
    if flash:
        return o.to(q.dtype)
    return _finish(o, l, q.dtype)


# -- striped attention (balanced causal ring) -------------------------------
#
# The contiguous causal ring is load-imbalanced: a block from a later
# source is invisible, so low ranks idle while rank n-1 does n real
# blocks. In the striped layout rank r holds global positions {j*n + r};
# then for any (idx, src) the visible set is triangular over local
# indices — jq > jk always visible, jq == jk iff idx >= src — and every
# rank does ~s^2/2 work on every hop.


def stripe_layout(x: torch.Tensor, n: int) -> torch.Tensor:
    """A contiguous global sequence ``(B, S, ...)`` in stripe order: new
    position ``r*(S/n) + j`` holds global token ``j*n + r``, so a plain
    contiguous shard over ``n`` ranks hands rank ``r`` the stripe
    ``{j*n + r}``."""
    b, s = x.shape[:2]
    xs = x.reshape((b, s // n, n) + tuple(x.shape[2:]))
    return torch.movedim(xs, 2, 1).reshape(x.shape)


def unstripe_layout(x: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`stripe_layout`."""
    b, s = x.shape[:2]
    xs = x.reshape((b, n, s // n) + tuple(x.shape[2:]))
    return torch.movedim(xs, 2, 1).reshape(x.shape)


def striped_positions(s_local: int, axis="sp", device=None) -> torch.Tensor:
    """``(S_local,)`` global position ids of this rank's stripe — the
    positions RoPE takes."""
    ax = C._axis(axis)
    return torch.arange(s_local, device=device) * ax.size + ax.index


def striped_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis="sp", use_flash: Optional[bool] = None,
                      wire: Optional[str] = None, wire_key=None
                      ) -> torch.Tensor:
    """Causal attention over STRIPE-sharded q/k/v ``(B, S_local, H, D)``
    (see :func:`stripe_layout`); causality over GLOBAL positions.

    In the flash form a block from a later source (``idx < src``) is the
    strict block: K/V rolled one position and key 0 masked, so causal
    over the shifted keys is exactly ``jq >= jk + 1`` over the originals.
    Its query row 0 then sees only a masked key — a fully masked row
    whose ``lse`` is -1e30 — and the combine weighs it 0 (the diagonal
    block, always the first, already gave that row a real ``lse``)."""
    wire = resolve_seq_wire(wire)
    ax = C._axis(axis)
    n, idx = ax.size, ax.index
    b, s, h, d = q.shape
    perm = _ring_perm(n)
    C.count_seq_kv_bytes(ax.name, wire, k.numel() + v.numel(), n,
                         k.element_size(), n - 1)
    flash = _use_flash(q, use_flash)
    if flash:
        o, lse = _empty_partial(q)
        strict_mask = torch.ones((b, s), dtype=torch.float32,
                                 device=q.device)
        strict_mask[:, 0] = 0.0
    else:
        m = torch.full((b, h, s), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
        o = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
        jq = torch.arange(s, device=q.device)[:, None]
        jk = torch.arange(s, device=q.device)[None, :]
    k_cur, v_cur = k, v
    for i in range(n):
        src = (idx - i) % n
        if flash:
            if idx >= src:
                o_i, lse_i = _flash_block(q, k_cur, v_cur, None, True)
            else:
                o_i, lse_i = _flash_block(q, torch.roll(k_cur, 1, dims=1),
                                          torch.roll(v_cur, 1, dims=1),
                                          strict_mask, True)
            o, lse = _combine_partial(o, lse, o_i, lse_i)
        else:
            # Global causality on stripes: (jq - jk) * n >= src - idx.
            blk = ((jq - jk) * n >= src - idx)[None, None]
            m, l, o = _block_attend(q, k_cur, v_cur, m, l, o, blk)
        if i < n - 1:
            k_cur = _seq_hop(k_cur, ax, perm, wire, wire_key, 2 * i)
            v_cur = _seq_hop(v_cur, ax, perm, wire, wire_key, 2 * i + 1)
    if flash:
        return o.to(q.dtype)
    return _finish(o, l, q.dtype)


def striped_attend_fn(axis="sp", wire: Optional[str] = None, wire_key=None,
                      use_flash: Optional[bool] = None):
    """The causal models' ``attend_fn`` for striped sequence parallelism;
    pair it with :func:`striped_positions` for RoPE."""

    def attend(q, k, v, mask=None):
        if mask is not None:
            raise NotImplementedError(
                "striped attention + key mask: rotate the mask with the "
                "stripes via ring_attention instead")
        return striped_attention(q, k, v, axis, use_flash=use_flash,
                                 wire=wire, wire_key=wire_key)

    return attend


def ring_attend_fn(axis="sp", causal: bool = False,
                   wire: Optional[str] = None, wire_key=None,
                   use_flash: Optional[bool] = None):
    """An ``attend_fn`` running :func:`ring_attention` (the key mask of
    the local shard rotates with its block)."""

    def attend(q, k, v, mask=None):
        return ring_attention(q, k, v, axis, causal=causal, mask=mask,
                              use_flash=use_flash, wire=wire,
                              wire_key=wire_key)

    return attend

