"""Adasum — adaptive summation allreduce, the port of
``horovod_tpu/ops/adasum.py``'s flat-axis recursion.

The pairwise adaptive combine (reference adasum.h:371-390)::

    combined = a * (1 - dot(a,b) / (2*||a||^2))
             + b * (1 - dot(a,b) / (2*||b||^2))

applied over a binary tree of ranks: level ``l`` pairs rank ``r`` with
``r ^ 2^l`` (distance doubling), so after ``log2(n)`` levels every rank
holds the Adasum of all ``n`` contributions. Each level exchanges full
vectors with the partner (``collectives.pair_exchange``) and runs the
combine's two passes as kernels: K8 ``adasum_dot_norms`` and K9
``adasum_combine`` (``ops/kernels.py``), both symmetric in (a, b) to the
bit, so the two partners of a pair hold equal results and replicas never
drift. Scalars are fp32 by default (the kernels); another
``scalar_dtype`` (``HVD_TPU_ADASUM_SCALAR_DTYPE``) computes them in plain
torch, as the JAX package does in jnp.

``wire="int8"`` carries each hop as block-scaled int8 (K2, or K3 with a
``key``, and K4): both partners dequantize BOTH sides of the pair before
the combine; ``wire="bf16"`` likewise casts both sides.

The recursion runs over any axis (``axis=``, the world by default). On
the mesh router's shards (``collectives.mesh_allreduce(op=ADASUM)``)
``scalar_axes`` names the fast axes the shards were reduce-scattered
over: K8's three scalars are gathered over them and summed in axis
order before K9, so every shard takes the full vector's coefficients
and the two partners of a pair the same bits — the reference's vector
halving with its three scalars reduced over the reduction communicator.
:func:`adasum_hierarchical` is the full-vector form: the local average,
then the recursion over the cross axis.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import basics
from ..common import metrics as metrics_lib
from . import collectives as C
from . import kernels

WIRES = ("none", "bf16", "int8")

_METRICS_ON = metrics_lib.enabled()
_M_COMBINES = metrics_lib.counter(
    "hvd_tpu_adasum_combines_total",
    "Adasum pairwise-combine stages run, by exchange wire format (one a "
    "recursion level a reduced tensor)",
    labels=("wire",))


def _dot_norms(a: torch.Tensor, b: torch.Tensor,
               scalar_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[dot(a, b), |a|^2, |b|^2]``: K8 in fp32, plain torch in any other
    ``scalar_dtype``."""
    if scalar_dtype == torch.float32:
        return kernels.adasum_dot_norms(a, b)
    af = a.reshape(-1).to(scalar_dtype)
    bf = b.reshape(-1).to(scalar_dtype)
    return torch.stack([torch.dot(af, bf), torch.dot(af, af),
                        torch.dot(bf, bf)])


def _combine_from_norms(a: torch.Tensor, b: torch.Tensor, dn: torch.Tensor,
                        scalar_dtype: torch.dtype = torch.float32,
                        eps: float = kernels.ADASUM_EPS) -> torch.Tensor:
    """The combine from K8's scalars: K9 in fp32, plain torch otherwise
    (coefficients cast to the operands' dtypes, as in JAX)."""
    if scalar_dtype == torch.float32:
        return kernels.adasum_combine(a, b, dn.to(torch.float32), eps=eps)
    dot, na2, nb2 = dn[0], dn[1], dn[2]
    ca = kernels._adasum_coefficient(dot, na2, eps)
    cb = kernels._adasum_coefficient(dot, nb2, eps)
    return ca.to(a.dtype) * a + cb.to(b.dtype) * b


def _pairwise_combine(a: torch.Tensor, b: torch.Tensor,
                      scalar_dtype: torch.dtype = torch.float32,
                      eps: float = kernels.ADASUM_EPS,
                      scalar_axes: Sequence = ()) -> torch.Tensor:
    """The adaptive combine of two same-shaped tensors: a plain sum when
    they are orthogonal, their average when they are parallel; a side of
    zero norm takes coefficient 1. With ``scalar_axes`` (``a`` and ``b``
    shards of longer vectors) the scalars are summed over those axes
    first, in axis order."""
    dn = _dot_norms(a, b, scalar_dtype)
    for ax in scalar_axes:
        dn = C.all_gather_stack(dn, ax).sum(dim=0)
    return _combine_from_norms(a, b, dn, scalar_dtype, eps)


def _exchange(x: torch.Tensor, partner: int, wire: str, key, axis=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pairwise hop in the level's wire format. Returns ``(a, b)``,
    the SELF and PARTNER views the combine consumes; on a lossy wire both
    come from the wire form (self included), so the pair computes
    identical combines."""
    if wire == "int8":
        q, s, n = C._quantize(x.contiguous().reshape(-1), key)
        qp = C.pair_exchange(q, partner, axis)
        sp = C.pair_exchange(s, partner, axis)
        a = kernels.dequantize_int8(q, s, n, x.shape, torch.float32)
        b = kernels.dequantize_int8(qp, sp, n, x.shape, torch.float32)
        return a.to(x.dtype), b.to(x.dtype)
    if wire == "bf16":
        xl = x.to(torch.bfloat16)
        return xl.to(x.dtype), C.pair_exchange(xl, partner,
                                               axis).to(x.dtype)
    return x, C.pair_exchange(x, partner, axis)


def adasum_allreduce(x: torch.Tensor,
                     scalar_dtype: Optional[torch.dtype] = None,
                     wire: str = "none", key=None, axis=None,
                     scalar_axes: Sequence = ()) -> torch.Tensor:
    """Adasum-allreduce ``x`` over every rank of ``axis`` (the world by
    default); ``scalar_axes`` sums the dot/norm scalars over further
    axes, for shards (see the module's docstring).

    Requires a power-of-two world size (the reference's VHDD makes the
    same assumption). ``scalar_dtype`` None is the configured dtype of
    the dot/norm scalars (``HVD_TPU_ADASUM_SCALAR_DTYPE``, float32).
    ``wire`` is the exchange payload per level:
    ``"none"`` (native dtype), ``"bf16"`` or ``"int8"`` (block-scaled,
    one fp32 scale per 4096 elements; a ``key`` makes the rounding
    stochastic, folded per level). Returns ``x`` itself at world size 1
    (no level runs)."""
    if wire not in WIRES:
        raise ValueError(f"unsupported Adasum wire {wire!r}; one of {WIRES}")
    ax = C._axis(axis)
    scalar_axes = [C._axis(a) for a in scalar_axes]
    n = ax.size
    if n & (n - 1) != 0:
        raise ValueError(f"Adasum requires power-of-two ranks, got {n}")
    if scalar_dtype is None:
        scalar_dtype = getattr(
            torch, basics.context().config.adasum_scalar_dtype)
    for lvl in range(n.bit_length() - 1):
        kl = None if key is None else C.fold_in(key, lvl)
        a, b = _exchange(x, ax.index ^ (1 << lvl), wire, kl, ax)
        x = _pairwise_combine(a, b, scalar_dtype, scalar_axes=scalar_axes)
        if _METRICS_ON:
            _M_COMBINES.labels(wire=wire).inc()
    return x


def adasum_hierarchical(x: torch.Tensor, local_axis="local",
                        cross_axis="cross",
                        scalar_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """Hierarchical Adasum, the full-vector form: the average over the
    local axis, then the Adasum recursion over the cross axis
    (``horovod_tpu/ops/adasum.py`` ``adasum_hierarchical``). The sharded
    form, with the same result, is ``collectives.mesh_allreduce(op=
    ADASUM)``."""
    local_avg = C.allreduce(x, C.ReduceOp.AVERAGE, axis=local_axis)
    return adasum_allreduce(local_avg, scalar_dtype, axis=cross_axis)


def adasum_allreduce_reference(tensors: Sequence,
                               scalar_dtype: Optional[type] = np.float64
                               ) -> np.ndarray:
    """Pure-NumPy reference of the same recursion, for tests (the JAX
    package's ``adasum_allreduce_reference``, copied)."""
    vals = [np.asarray(t, dtype=scalar_dtype) for t in tensors]
    n = len(vals)
    assert n & (n - 1) == 0
    lvl = 1
    while lvl < n:
        nxt = list(vals)
        for r in range(n):
            p = r ^ lvl
            a, b = vals[r], vals[p]
            dot = float((a * b).sum())
            na2 = float((a * a).sum())
            nb2 = float((b * b).sum())
            ac = 1.0 - dot / (2.0 * na2) if na2 > 0 else 1.0
            bc = 1.0 - dot / (2.0 * nb2) if nb2 > 0 else 1.0
            nxt[r] = ac * a + bc * b
        vals = nxt
        lvl <<= 1
    return vals[0]
