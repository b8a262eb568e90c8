"""Collective primitives of the port over ``torch.distributed`` — the
subset of ``horovod_tpu/ops/collectives.py`` the training slice needs.

The JAX functions reduce over a mesh axis inside a traced program; here
every call is an eager collective over the default process group that
``common.basics.init()`` set up (NCCL on the card, gloo on the CPU).
Results are new tensors unless a name ends in ``_`` (in place).

Ported: ``ReduceOp`` and its aliases, ``allreduce`` (SUM, AVERAGE, MIN,
MAX, with pre/postscale), ``grouped_allreduce``, ``allreduce_async_``,
``allgather``, ``broadcast``/``broadcast_`` and ``barrier``. PRODUCT,
ADASUM, the quantized and the hierarchical/mesh-routed reductions come
with later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import enum
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..common import basics


class ReduceOp(enum.IntEnum):
    """The JAX package's (and the reference C ABI's) enum values."""

    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT

_DIST_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.MAX: dist.ReduceOp.MAX}


def _apply_scale(x: torch.Tensor, scale: Optional[float]) -> torch.Tensor:
    """Pre/post-scaling: ``x`` itself at 1.0 (no multiply); integer
    tensors scale in fp64 and cast back (a cast scale would floor 0.5 to
    0), floats multiply in their own dtype."""
    if scale is None or scale == 1.0:
        return x
    if not (x.is_floating_point() or x.is_complex()):
        return (x.to(torch.float64) * scale).to(x.dtype)
    return x * scale


def _divide_by_size(y: torch.Tensor, n: int) -> torch.Tensor:
    """``y / n`` as an IEEE division. The divisor is a tensor on ``y``'s
    device: PyTorch turns division of a CUDA tensor by a Python scalar
    (or a CPU scalar tensor) into multiplication by its reciprocal, which
    is not exact for an n that is not a power of two. Integer tensors
    divide to floats, as the JAX package's ``psum / n`` does."""
    if n == 1 and y.is_floating_point():
        return y
    return y / torch.full((1,), n, dtype=y.dtype if y.is_floating_point()
                          else torch.float32, device=y.device)


def _reduce_in_place(x: torch.Tensor, op: ReduceOp, async_op: bool):
    if op in (ReduceOp.PRODUCT, ReduceOp.ADASUM):
        raise NotImplementedError(
            f"{op.name} reductions are not ported yet (Adasum comes with "
            "its own slice of the port, with the K8/K9 kernels)")
    dist_op = _DIST_OP.get(ReduceOp.SUM if op == ReduceOp.AVERAGE else op)
    if dist_op is None:
        raise ValueError(f"unsupported reduce op: {op}")
    return dist.all_reduce(x, op=dist_op, async_op=async_op)


def allreduce(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """Allreduce of ``x`` across all ranks; returns a new tensor.
    AVERAGE is a SUM followed by an exact division by the world size."""
    op = ReduceOp(op)
    n = basics.size()
    y = _apply_scale(x, prescale_factor)
    if y is x:
        y = x.clone()
    _reduce_in_place(y, op, async_op=False)
    if op == ReduceOp.AVERAGE:
        y = _divide_by_size(y, n)
    return _apply_scale(y, postscale_factor)


def allreduce_async_(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM):
    """In-place SUM/MIN/MAX allreduce of ``x``, issued asynchronously;
    returns the ``torch.distributed`` work handle (``.wait()`` before
    reading ``x``). AVERAGE needs a division after the wait: use
    :func:`allreduce`, or SUM and divide."""
    op = ReduceOp(op)
    if op == ReduceOp.AVERAGE:
        raise ValueError("allreduce_async_ takes SUM/MIN/MAX; AVERAGE is "
                         "a SUM followed by a division after the wait")
    basics.context()
    return _reduce_in_place(x, op, async_op=True)


def grouped_allreduce(xs: Sequence[torch.Tensor],
                      op: ReduceOp = ReduceOp.AVERAGE,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0) -> List[torch.Tensor]:
    """Allreduce a list of tensors as one logical step (callers wanting
    explicit fusion use ``common.fusion`` buckets)."""
    return [allreduce(x, op, prescale_factor, postscale_factor) for x in xs]


def allgather(x: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's ``x`` along dim 0 (all ranks' shapes must
    be equal)."""
    parts = [torch.empty_like(x) for _ in range(basics.size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts, dim=0)


def broadcast_(x: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """Overwrite ``x`` in place with ``root_rank``'s value; returns ``x``.
    A tensor off the process group's device (a CPU scalar in a CUDA run)
    travels through a device copy."""
    dev = basics.device()
    if x.device == dev:
        dist.broadcast(x, src=root_rank)
        return x
    tmp = x.detach().to(dev)
    dist.broadcast(tmp, src=root_rank)
    with torch.no_grad():
        x.copy_(tmp)
    return x


def broadcast(x: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """``root_rank``'s value of ``x`` as a new tensor on every rank."""
    return broadcast_(x.detach().clone(), root_rank)


def barrier() -> None:
    """Block until every rank has reached this call."""
    basics.context()
    dist.barrier()
