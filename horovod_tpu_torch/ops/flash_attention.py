"""Flash attention — the port of ``horovod_tpu/ops/flash_attention.py``.

The public functions keep the JAX package's contract: q, k, v are
``(B, S, H, D)`` as the models' fused QKV projection produces them,
``mask`` is an optional ``(B, S)`` key mask (1 = attend), and
``flash_attention_with_lse`` returns ``(o, lse)`` with ``lse`` ``(B, H,
S)`` fp32, both differentiable (the lse cotangent folds into the
backward's ``ds``, which blockwise callers such as ring attention need).

:class:`_FlashAttention` wraps the forward kernel K5
(``ops.kernels.flash_fwd``) and the backward kernels K6/K7
(``ops.kernels.flash_bwd``, one C call for both) as one
``torch.autograd.Function``.
A CUDA tensor launches the kernels or raises; a CPU tensor takes their
plain PyTorch versions. ``delta = rowsum(do * o)`` stays a plain torch
op, as it is plain jnp in the JAX package.

Unlike the JAX wrapper, no head-dim padding and no sequence-tiling
decline carry over: the CUDA kernels take D = 64 or 128 natively (scale
exactly ``1/sqrt(D)``) and any S, masking the ragged tail themselves.
``flash_available`` declines only on ``HVD_TPU_FLASH_ATTENTION=0``, and
then only CPU tensors take :func:`reference_attention`; a CUDA tensor
raises (a caller who wants plain attention on the card passes it as the
model's ``attend_fn``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..common.config import runtime_env
from . import kernels

MASK_VALUE = kernels.MASK_VALUE


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        causal: bool = False) -> torch.Tensor:
    """Plain softmax attention on (B, S, H, D): fp32 logits and softmax,
    masked logits at -1e30 (key mask and causal alike), output in q's
    dtype — the JAX package's numerics oracle, op for op."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(d)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :] > 0, logits,
                             torch.full_like(logits, MASK_VALUE))
    if causal:
        s = q.shape[1]
        keep = torch.ones((s, s), dtype=torch.bool,
                          device=q.device).tril()
        logits = torch.where(keep, logits,
                             torch.full_like(logits, MASK_VALUE))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs,
                        v.to(torch.float32)).to(q.dtype)


class _FlashAttention(torch.autograd.Function):
    """(o, lse) = K5(q, k, v); backward = K6 (dq) + K7 (dk, dv)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        o, lse = kernels.flash_fwd(q, k, v, mask, causal)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.causal = causal
        # An unused output's cotangent arrives as None, not as zeros
        # materialized for the kernel to read.
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, mask, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        elif do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = kernels.flash_bwd(q, k, v, mask, ctx.causal, o, lse,
                                       do, dlse)
        return dq, dk, dv, None, None


def flash_available(seq_len: int = 1) -> bool:
    """THE availability predicate: False only when the operator turned
    the kernels off (``HVD_TPU_FLASH_ATTENTION=0``) or there is no
    sequence. The JAX package also declines off-TPU and on sequences
    its blocks cannot tile; the port's kernels take any S."""
    return runtime_env("FLASH_ATTENTION", "1") != "0" and seq_len > 0


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             mask: Optional[torch.Tensor] = None,
                             causal: bool = False
                             ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Like :func:`flash_attention` but also returns the per-row
    logsumexp (B, H, S) fp32. Both outputs are differentiable. Returns
    None when :func:`flash_available` declines on CPU tensors, so
    callers use their own reference path; with any other tensor it
    raises, as no tensor on the card takes a plain path."""
    if not flash_available(q.shape[1]):
        devices = {t.device.type for t in (q, k, v, mask) if t is not None}
        if devices != {"cpu"}:
            raise RuntimeError(
                "flash attention is turned off (HVD_TPU_FLASH_ATTENTION=0) "
                f"but its inputs are on {sorted(devices)}: on the card it "
                "launches its kernels or raises; pass plain attention as "
                "the model's attend_fn instead")
        return None
    return _FlashAttention.apply(q, k, v, mask, causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """Blockwise online-softmax attention on (B, S, H, D), differentiable
    through the flash backward kernels. Falls back to
    :func:`reference_attention` only for CPU tensors where
    :func:`flash_available` declines."""
    out = flash_attention_with_lse(q, k, v, mask, causal)
    if out is None:
        return reference_attention(q, k, v, mask, causal)
    return out[0]


def attend(q, k, v, mask=None):
    """Drop-in non-causal ``attend_fn`` for the models (BERT-style)."""
    return flash_attention(q, k, v, mask=mask)
