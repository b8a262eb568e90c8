"""Collective primitives of the port over ``torch.distributed`` — the
per-process counterparts of ``horovod_tpu/ops/collectives.py``.

The JAX functions reduce over a mesh axis inside a traced program; here
every call is an eager collective over an axis: a
:class:`~..common.topology.Axis`, a mesh axis's name (``"local"``,
``"cross"``, ...; ``common.basics.init()`` made their subgroups) or
``None``, the world, i.e. the default process group (NCCL on the card,
gloo on the CPU or with ``init(backend="gloo")``). Indices in an axis
(a partner, a permutation, a broadcast root) are positions along it.
Results are new tensors unless a name ends in ``_`` (in place).

Ported: ``ReduceOp`` and its aliases, ``allreduce`` (SUM, AVERAGE, MIN,
MAX, PRODUCT and ADASUM, with pre/postscale through ``_apply_scale`` —
kernel K1 on a CUDA tensor), the optimizer's in-place asynchronous SUM
``_allreduce_async_inplace``, ``allgather`` and the
ragged ``allgatherv``, ``broadcast``/``broadcast_``, ``join_allreduce``,
the exchanges (even and
uneven ``alltoall``, ``compressed_alltoall`` on the bf16 and int8 wires
through K2/K4, ``reducescatter``), and the reduce-safe quantized
reduction (``quantized_reducescatter``, ``quantized_allreduce``: int8 on
every hop through K2 or K3, K4's format, the documented error bound and
the error-feedback residual); the two-level forms over a (cross,
local) mesh (``hierarchical_allreduce``, ``hierarchical_allreduce_staged``,
``hierarchical_allgather``, ``quantized_hierarchical_allreduce`` with K2
and K4 on the cross hop); and the topology-aware router
(``WirePlan``, ``mesh_reducescatter``/``mesh_allgather``/
``mesh_allreduce`` with a wire per axis, SUM/AVERAGE/ADASUM, keys and
error-feedback residuals, ``mesh_wire_cost``), the wired exchanges
(``ppermute``, ``wired_ppermute`` with its straight-through backward,
``alltoallv_chunked``). ``mesh_alltoall`` and the sequence-parallel byte
counters come with the parallel-roles slice.

A collective the eager engine runs asynchronously comes as an
``*_issue`` function returning :data:`Issued` — the works in flight and
the step that finishes the result after them (a division, a postscale,
a decompression); the blocking form waits at once.

Every collective here is one that gloo also runs on CUDA tensors
(staging them through host memory): ``all_reduce``, ``broadcast``,
``all_gather`` (the list form) and ``all_to_all_single`` (with split
sizes too). A reduce-scatter is an ``all_to_all_single`` and a sum in
rank order; a ragged gather pads to the longest rank. A permutation
(:func:`ppermute`, :func:`pair_exchange`) is an ``all_to_all_single``
whose split sizes are zero except toward the destination and from the
source, since gloo's ``send``/``recv`` do not take CUDA tensors. The
same calls run over NCCL when each rank has its own GPU.

Stochastic rounding keys are tuples of ints (the JAX package's
``jax.random`` keys): :func:`fold_in` appends one, and the thresholds of
a quantization are ``torch.rand`` draws from a generator seeded by a hash
of the key, so every rank draws the same ``u`` for the same key, as
every SPMD rank of the JAX package does. The draws differ from
``jax.random``'s.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..common import basics
from ..common import metrics as metrics_lib
from ..common import overlap as overlap_lib
from ..common.topology import Axis
from . import kernels


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
            ReduceOp.MAX: dist.ReduceOp.MAX,
            ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}


_SCALED_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def _axis(axis=None) -> Axis:
    """The :class:`Axis` a collective runs over: ``axis`` itself, the
    mesh axis of that name, or the world for None. Every collective of
    this module resolves its axis here, after the overlap workers'
    submitted chains have run (``overlap.drain_before_collective``)."""
    overlap_lib.drain_before_collective()
    if isinstance(axis, Axis):
        return axis
    ctx = basics.context()
    return ctx.world_axis if axis is None else ctx.axis(axis)


def _apply_scale(x: torch.Tensor, scale: Optional[float]) -> torch.Tensor:
    """Pre/post-scaling, the JAX package's ``x * asarray(scale, x.dtype)``:
    ``x`` itself at 1.0 (no multiply). A float32/bf16/fp16 tensor is
    multiplied by the scale rounded to its own dtype, in fp32 with one
    rounding back — kernel K1 on a CUDA tensor, its plain version on the
    CPU; for bf16 and fp16 the fp32 product of two such values is exact,
    so the result is the correctly rounded product in the tensor's dtype.
    Integer tensors scale in fp64 and cast back (the JAX package's x64
    path: a cast scale would floor 0.5 to 0); float64 and complex tensors
    multiply in their own dtype."""
    if scale is None or scale == 1.0:
        return x
    if not (x.is_floating_point() or x.is_complex()):
        return (x.to(torch.float64) * scale).to(x.dtype)
    if x.dtype not in _SCALED_FLOATS:
        return x * scale
    rounded = torch.tensor(scale, dtype=x.dtype).item()
    return kernels.scale_buffer(x.contiguous(), rounded)


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


def _reduce_in_place(x: torch.Tensor, op: ReduceOp, async_op: bool,
                     group=None):
    if op == ReduceOp.ADASUM:
        raise ValueError("Adasum is no in-place sum: call allreduce(x, "
                         "op=Adasum)")
    dist_op = _DIST_OP.get(ReduceOp.SUM if op == ReduceOp.AVERAGE else op)
    if dist_op is None:
        raise ValueError(f"unsupported reduce op: {op}")
    return dist.all_reduce(x, op=dist_op, async_op=async_op, group=group)


# An issued collective: the ``torch.distributed`` works in flight and the
# step that turns their buffers into the result once every work has
# landed. The eager engine keeps it in a handle; the blocking forms below
# wait at once.
Issued = Tuple[List, Callable[[], Any]]


def wait_issued(issued: Issued):
    """Wait for every work of ``issued`` and return its result."""
    works, finish = issued
    for work in works:
        work.wait()
    return finish()


def _done(y) -> Issued:
    return [], lambda: y


def _owned(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``y`` as a contiguous buffer the caller may overwrite (a copy when
    it is still the caller's ``x``)."""
    if y is x or not y.is_contiguous():
        return y.detach().clone(memory_format=torch.contiguous_format)
    return y


def allreduce_issue(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0, axis=None) -> Issued:
    """:func:`allreduce`, issued: the prescale and the reduction are
    queued; the division (AVERAGE) and the postscale run at the finish.
    ADASUM runs to its end here."""
    op = ReduceOp(op)
    ax = _axis(axis)
    n = ax.size
    y = _apply_scale(x, prescale_factor)
    if op == ReduceOp.ADASUM:
        from . import adasum as adasum_lib

        y = adasum_lib.adasum_allreduce(y, axis=ax)
        return _done(_apply_scale(x.clone() if y is x else y,
                                  postscale_factor))
    y = _owned(x, y)
    work = _reduce_in_place(y, op, async_op=True, group=ax.group)

    def finish():
        z = _divide_by_size(y, n) if op == ReduceOp.AVERAGE else y
        return _apply_scale(z, postscale_factor)
    return [work], finish


def allreduce(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0, axis=None) -> torch.Tensor:
    """Allreduce of ``x`` across the ranks of ``axis`` (the world by
    default); returns a new tensor. AVERAGE is a SUM followed by an exact
    division by the axis size; PRODUCT, MIN and MAX reduce elementwise;
    ADASUM is ``adasum.adasum_allreduce`` with the configured scalar
    dtype (``HVD_TPU_ADASUM_SCALAR_DTYPE``)."""
    return wait_issued(allreduce_issue(x, op, prescale_factor,
                                       postscale_factor, axis))


def _allreduce_async_inplace(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                             axis=None):
    """In-place SUM/MIN/MAX/PRODUCT allreduce of ``x``, issued
    asynchronously; returns the ``torch.distributed`` work handle
    (``.wait()`` before reading ``x``). AVERAGE needs a division after
    the wait: use :func:`allreduce`, or SUM and divide. The fused-bucket
    primitive of ``DistributedOptimizer``; Horovod's public
    ``allreduce_async_`` (an int handle) is the package's, on the eager
    engine."""
    op = ReduceOp(op)
    if op == ReduceOp.AVERAGE:
        raise ValueError("_allreduce_async_inplace takes SUM/MIN/MAX/"
                         "PRODUCT; AVERAGE is a SUM followed by a "
                         "division after the wait")
    return _reduce_in_place(x, op, async_op=True, group=_axis(axis).group)


def join_allreduce(x: torch.Tensor, joined: bool, active: int,
                   op: ReduceOp = ReduceOp.AVERAGE, axis=None
                   ) -> torch.Tensor:
    """Allreduce in which a rank that has joined contributes zeros and
    AVERAGE divides by the ``active`` ranks (at least 1) — the reference's
    JoinOp, ``horovod_tpu/ops/collectives.py`` ``join_allreduce``. Every
    rank passes the same ``active`` (the join round tells it)."""
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("join supports SUM/AVERAGE")
    y = torch.zeros_like(x) if joined else _owned(x, x)
    _reduce_in_place(y, ReduceOp.SUM, async_op=False,
                     group=_axis(axis).group)
    if op == ReduceOp.AVERAGE:
        y = _divide_by_size(y, max(active, 1))
    return y


def allgather_issue(x: torch.Tensor, axis=None) -> Issued:
    """:func:`allgather`, issued."""
    ax = _axis(axis)
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(ax.size)]
    work = dist.all_gather(parts, x.contiguous(), async_op=True,
                           group=ax.group)
    return [work], lambda: torch.cat(parts, dim=0)


def allgather(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Every rank's ``x`` of ``axis``, concatenated along dim 0 in axis
    order."""
    return wait_issued(allgather_issue(x, axis))


def allgatherv_issue(x: torch.Tensor, sizes: Sequence[int],
                     axis=None) -> Issued:
    """Ragged allgather: rank ``r`` holds ``sizes[r]`` rows (the table
    every rank agrees on, ``horovod_tpu/ops/collectives.py``
    ``allgatherv``); the result is every rank's rows in rank order. Each
    buffer is zero-padded to ``max(sizes)`` rows and gathered with the
    even list-form ``all_gather`` (which gloo runs on CUDA tensors)."""
    ax = _axis(axis)
    n, me = ax.size, ax.index
    if len(sizes) != n or x.shape[0] != sizes[me]:
        raise ValueError(f"allgatherv: rank {me} holds {x.shape[0]} rows; "
                         f"the size table says {list(sizes)}")
    maxs = max(sizes)
    padded = x.new_zeros((maxs,) + tuple(x.shape[1:]))
    padded[:x.shape[0]] = x
    parts = [torch.empty_like(padded) for _ in range(n)]
    work = dist.all_gather(parts, padded, async_op=True, group=ax.group)
    return [work], lambda: torch.cat(
        [p[:k] for p, k in zip(parts, sizes)], dim=0)


def broadcast_(x: torch.Tensor, root_rank: int = 0, axis=None
               ) -> torch.Tensor:
    """Overwrite ``x`` in place with the value of the rank at position
    ``root_rank`` of ``axis`` (the world's rank ``root_rank`` by
    default); returns ``x``. A tensor off the process group's device (a
    CPU scalar in a CUDA run) travels through a device copy."""
    ax = _axis(axis)
    src = ax.ranks[root_rank]
    dev = basics.device()
    if x.device == dev:
        dist.broadcast(x, src=src, group=ax.group)
        return x
    tmp = x.detach().to(dev)
    dist.broadcast(tmp, src=src, group=ax.group)
    with torch.no_grad():
        x.copy_(tmp)
    return x


def broadcast_issue(x: torch.Tensor, root_rank: int = 0,
                    axis=None) -> Issued:
    """The value of ``x`` at position ``root_rank`` of ``axis`` as a new
    tensor, issued."""
    ax = _axis(axis)
    y = _owned(x, x)
    work = dist.broadcast(y, src=ax.ranks[root_rank], async_op=True,
                          group=ax.group)
    return [work], lambda: y


# -- exchanges ----------------------------------------------------------------

def all_to_all(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Rank ``j`` of ``axis`` receives block ``j`` of every rank's ``x``
    (blocks along dim 0, one per rank), stacked in axis order."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=_axis(axis).group)
    return out


def all_gather_stack(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Every rank's ``x`` of ``axis`` stacked along a new leading dim, in
    axis order (the list form of ``all_gather``, which gloo runs on CUDA
    tensors)."""
    ax = _axis(axis)
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x.contiguous(), group=ax.group)
    return torch.stack(parts)


def ppermute(x: torch.Tensor, perm, axis=None) -> torch.Tensor:
    """``lax.ppermute`` over ``axis``: ``perm`` holds ``(source,
    destination)`` pairs of axis positions, each position at most once a
    source and once a destination; a rank that is no destination gets
    zeros. One ``all_to_all_single`` whose split sizes are zero except
    toward this rank's destination and from its source. Every rank of
    the axis calls it in the same step, with the same ``perm``."""
    ax = _axis(axis)
    me = ax.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: position {me} appears more than once "
                         f"as a source or a destination in {list(perm)}")
    flat = x.contiguous().reshape(-1)
    if dst == [me] and src == [me]:
        return flat.clone().reshape(x.shape)
    send, recv = [0] * ax.size, [0] * ax.size
    if dst:
        send[dst[0]] = flat.numel()
    if src:
        recv[src[0]] = flat.numel()
    out = torch.empty_like(flat) if src else torch.zeros_like(flat)
    dist.all_to_all_single(out, flat, output_split_sizes=recv,
                           input_split_sizes=send, group=ax.group)
    return out.reshape(x.shape)


def pair_exchange(x: torch.Tensor, partner: int, axis=None) -> torch.Tensor:
    """``partner``'s ``x`` (same shape and dtype on both sides), while
    ``partner`` receives this rank's: a :func:`ppermute` of the pair.
    Every rank of the axis must call it in the same step (each with its
    own partner)."""
    me = _axis(axis).index
    return ppermute(x, [(me, partner), (partner, me)], axis)


def _even_rows(x: torch.Tensor, n: int, what: str) -> int:
    if x.dim() == 0 or x.shape[0] % n:
        raise ValueError(f"{what}: dim 0 ({tuple(x.shape)[:1]}) must divide "
                         f"into {n} chunks")
    return x.shape[0] // n


def alltoall_issue(x: torch.Tensor, axis=None) -> Issued:
    """Even all-to-all (``horovod_tpu/ops/collectives.py`` ``alltoall``):
    dim 0 splits into ``n`` equal chunks, chunk ``j`` goes to rank ``j``,
    and the received chunks concatenate along dim 0 in rank order."""
    ax = _axis(axis)
    _even_rows(x, ax.size, "alltoall")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    work = dist.all_to_all_single(out, xc, async_op=True, group=ax.group)
    return [work], lambda: out


def alltoallv_issue(x: torch.Tensor, splits: Sequence[int],
                    recv_splits: Sequence[int], axis=None) -> Issued:
    """Uneven all-to-all: this rank sends ``splits[d]`` consecutive rows
    to rank ``d`` and receives ``recv_splits[s]`` from rank ``s``,
    concatenated in rank order (one ``all_to_all_single`` with split
    sizes, which gloo runs on CUDA tensors)."""
    splits, recv_splits = [int(s) for s in splits], \
        [int(s) for s in recv_splits]
    if sum(splits) != x.shape[0]:
        raise ValueError(f"alltoallv: sum(splits) = {sum(splits)} != send "
                         f"rows {x.shape[0]}")
    xc = x.contiguous()
    out = xc.new_empty((sum(recv_splits),) + tuple(x.shape[1:]))
    work = dist.all_to_all_single(out, xc, output_split_sizes=recv_splits,
                                  input_split_sizes=splits, async_op=True,
                                  group=_axis(axis).group)
    return [work], lambda: out


WIRES = ("none", "bf16", "int8")


def compressed_alltoall_issue(x: torch.Tensor, wire: str = "int8",
                              axis=None) -> Issued:
    """Wire-compressed even all-to-all (``horovod_tpu/ops/collectives.py``
    ``compressed_alltoall``): ``"none"`` sends the native dtype,
    ``"bf16"`` casts around the exchange, ``"int8"`` quantizes each
    rank's chunks with K2 (one fp32 scale per 4096-element block, each
    chunk zero-padded to whole blocks), exchanges codes and scales, and
    dequantizes what arrived with K4. Integer payloads, and any payload
    in a world of one, ride uncompressed. Error bound per element (lossy
    wires): half a block scale (int8), one bf16 step (bf16)."""
    if wire not in WIRES:
        raise ValueError(f"unknown wire format {wire!r}; choose from "
                         f"{WIRES}")
    ax = _axis(axis)
    n = ax.size
    m = _even_rows(x, n, "compressed_alltoall")
    if n == 1 or wire == "none" or not x.is_floating_point():
        return alltoall_issue(x, ax)
    if wire == "bf16":
        works, finish = alltoall_issue(x.to(torch.bfloat16), ax)
        return works, lambda: finish().to(x.dtype)
    rest = tuple(x.shape[1:])
    c = x.numel() // n
    pad = -c % _Q_BLOCK
    chunks = x.reshape(n, c).to(torch.float32)
    flat = torch.nn.functional.pad(chunks, (0, pad)).reshape(-1)
    q, s = _int8_chunks(flat, n, None)
    q, s = q.reshape(-1, q.shape[-1]), s.reshape(-1)
    qx, sx = torch.empty_like(q), torch.empty_like(s)
    works = [dist.all_to_all_single(qx, q, async_op=True, group=ax.group),
             dist.all_to_all_single(sx, s, async_op=True, group=ax.group)]
    deq_dtype = x.dtype if x.dtype in (torch.float32, torch.bfloat16) \
        else torch.float32

    def finish():
        out = kernels.dequantize_int8(qx, sx, flat.numel(), (n, c + pad),
                                      deq_dtype)
        return out[:, :c].to(x.dtype).reshape((n * m,) + rest)
    return works, finish


def reducescatter_issue(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                        axis=None) -> Issued:
    """Reduce-scatter along dim 0 (``horovod_tpu/ops/collectives.py``
    ``reducescatter``): this rank's 1/n slice of the elementwise SUM (or
    AVERAGE) over ranks. One ``all_to_all_single`` brings every rank's
    copy of this rank's slice here; they are summed in rank order, the
    same on NCCL and on gloo (whose ``reduce_scatter`` is not used)."""
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("reducescatter supports SUM/AVERAGE")
    ax = _axis(axis)
    n = ax.size
    m = _even_rows(x, n, "reducescatter")
    works, exchanged = alltoall_issue(x, ax)

    def finish():
        parts = exchanged().reshape((n, m) + tuple(x.shape[1:]))
        acc = parts[0].clone()
        for src in range(1, n):
            acc += parts[src]
        return _divide_by_size(acc, n) if op == ReduceOp.AVERAGE else acc
    return works, finish


def reducescatter(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                  axis=None) -> torch.Tensor:
    """This rank's 1/n slice (dim 0) of the SUM or AVERAGE over the
    ranks of ``axis``, summed in axis order."""
    return wait_issued(reducescatter_issue(x, op, axis))


# -- stochastic-rounding keys -------------------------------------------------

def fold_in(key: Tuple[int, ...], data: int) -> Tuple[int, ...]:
    """A new key from ``key`` and ``data`` (``jax.random.fold_in``)."""
    return tuple(int(k) for k in key) + (int(data),)


def uniform(key: Tuple[int, ...], rows: int,
            device: torch.device) -> torch.Tensor:
    """``(rows, 128)`` fp32 draws in [0, 1) from a generator seeded by
    ``key``: the same on every rank for the same key."""
    digest = hashlib.blake2b(repr(tuple(int(k) for k in key)).encode(),
                             digest_size=8).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest, "little") & (2 ** 63 - 1))
    return torch.rand((rows, 128), generator=gen, device=device,
                      dtype=torch.float32)


# -- reduce-safe quantized allreduce ------------------------------------------
#
# The JAX package's EQuARX decomposition (collectives.py:562-749): an int8
# payload cannot ride a sum (per-block scales do not commute with it), so
# the allreduce becomes an int8 reduce-scatter (an all_to_all of the
# quantized chunks with their scales), an fp32 dequantize-and-sum of the
# chunk each rank owns, a requantization of that chunk and an all-gather
# of the int8 result.

_Q_BLOCK = kernels.BLOCK


def _quantize(flat: torch.Tensor, key):
    """K2 (``key=None``, round to nearest) or K3 (stochastic, thresholds
    drawn from ``key``) of a flat fp32 buffer."""
    if key is None:
        return kernels.quantize_int8(flat)
    rows = kernels.stochastic_rows(flat.numel())
    return kernels.quantize_int8_stochastic(
        flat, uniform(key, rows, flat.device))


def _int8_chunks(flat_pad: torch.Tensor, n: int, key):
    """Quantize a (n*chunk,) fp32 buffer, chunk % 4096 == 0, into per-rank
    stacks: q (n, rows, 128) int8 and scales (n, nblocks) fp32."""
    q, s, _ = _quantize(flat_pad, key)
    chunk = flat_pad.shape[0] // n
    return (q.reshape(n, chunk // 128, 128),
            s.reshape(n, chunk // _Q_BLOCK))


def _deq(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Dequantize a stacked (..., rows, 128) int8 and (..., nblocks) scale
    pair to fp32 of shape (..., nblocks * 4096): plain torch, as the JAX
    package's ``_deq`` is plain jnp."""
    nb = s.shape[-1]
    lead = tuple(q.shape[:-2])
    blocks = q.reshape(lead + (nb, _Q_BLOCK)).to(torch.float32)
    return (blocks * s[..., None]).reshape(lead + (nb * _Q_BLOCK,))


def quantized_reducescatter(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                            key=None, return_residual: bool = False,
                            axis=None):
    """Reduce-scatter of a flat buffer with an int8 payload on the wire.

    ``x`` is 1-D with ``x.shape[0] % (n * 4096) == 0`` (zero-pad: pads
    quantize to exact 0). Returns this rank's reduced chunk of
    ``x.shape[0] // n`` elements in ``x.dtype``; with
    ``return_residual=True`` also the full-length fp32 local quantization
    error ``x - dequant(quant(x))``."""
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("quantized reducescatter supports SUM/AVERAGE")
    ax = _axis(axis)
    n = ax.size
    if x.dim() != 1 or x.shape[0] % (n * _Q_BLOCK):
        raise ValueError(
            f"quantized_reducescatter needs a 1-D buffer with length "
            f"divisible by n*4096 = {n * _Q_BLOCK}; got {tuple(x.shape)} "
            "(zero-pad — pads quantize to exact 0)")
    flat = x.to(torch.float32)
    q, s = _int8_chunks(flat, n, key)
    if n == 1:
        own = _deq(q[0], s[0])
    else:
        own = _deq(all_to_all(q, ax), all_to_all(s, ax)).sum(dim=0)
    if op == ReduceOp.AVERAGE:
        own = _divide_by_size(own, n)
    if not return_residual:
        return own.to(x.dtype)
    return own.to(x.dtype), flat - _deq(q, s).reshape(flat.shape)


def quantized_allreduce(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
                        key=None, return_residual: bool = False,
                        axis=None):
    """Reduce-safe quantized allreduce: block-scaled int8 on every hop.

    Flatten and zero-pad ``x`` so it splits into ``n`` block-aligned
    chunks, quantize (stochastically from ``fold_in(key, 0)`` when a key
    is given), reduce-scatter the int8 chunks (:func:`
    quantized_reducescatter`), requantize the reduced chunk (from
    ``fold_in(key, 1)``), all-gather the int8 chunks and scales,
    dequantize, unpad and reshape.

    Error bound (the JAX package's): each element differs from the exact
    fp32 sum by at most ``r * (sum over ranks of s_rank + s_reduced)``,
    ``s`` the per-block scales absmax/127, ``r = 1/2`` round to nearest
    (``key=None``) and ``r = 1`` stochastic; divide by ``n`` for AVERAGE.

    ``return_residual=True`` also returns the fp32 local error (this
    rank's contribution rounding over the whole buffer, plus the
    requantization error of the chunk it owns) for error feedback. At
    ``n == 1`` nothing is quantized: the result is ``x`` and the residual
    zero."""
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("quantized allreduce supports SUM/AVERAGE "
                         "(per-block scales only compose with linear "
                         "reductions)")
    ax = _axis(axis)
    n = ax.size
    if n == 1:
        # No wire at all — quantizing would add pure rounding loss.
        y = x.clone()
        if return_residual:
            return y, torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device)
        return y
    size = x.numel()
    chunk = -(-size // (n * _Q_BLOCK)) * _Q_BLOCK
    flat = torch.zeros(n * chunk, dtype=torch.float32, device=x.device)
    flat[:size] = x.reshape(-1)
    kc = None if key is None else fold_in(key, 0)
    rs = quantized_reducescatter(flat, ReduceOp.SUM, key=kc,
                                 return_residual=return_residual, axis=ax)
    own, residual = rs if return_residual else (rs, None)
    kr = None if key is None else fold_in(key, 1)
    qr, sr = _int8_chunks(own, 1, kr)
    red = _deq(all_gather_stack(qr[0], ax), all_gather_stack(sr[0], ax))
    y = red.reshape(-1)[:size].reshape(x.shape)
    if op == ReduceOp.AVERAGE:
        y = _divide_by_size(y, n)
    y = y.to(x.dtype)
    if not return_residual:
        return y
    # The requantize error of the owned chunk joins this rank's residual:
    # residuals are summed across ranks through the next step's
    # reduction, so the owner carrying it corrects the sum just the same.
    me = ax.index
    residual[me * chunk:(me + 1) * chunk] += own - _deq(qr[0], sr[0])
    return y, residual[:size].reshape(x.shape)


# -- two-level forms over a (cross, local) mesh -------------------------------
#
# The JAX package's hierarchical variants (collectives.py:183, 476-585,
# 1529): the local axis is the fast one (within a host), the cross axis
# the slow hop between hosts. Ranks are host-major, so a local gather
# then a cross gather keeps the flat row order.

def hierarchical_allreduce(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
                           local_axis="local", cross_axis="cross"
                           ) -> torch.Tensor:
    """Two-phase SUM/AVERAGE allreduce: a sum over the local axis, then
    over the cross axis (every rank ends with the same bits); AVERAGE
    divides once by the mesh size."""
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("hierarchical allreduce supports SUM/AVERAGE")
    la, ca = _axis(local_axis), _axis(cross_axis)
    y = _owned(x, x)
    _reduce_in_place(y, ReduceOp.SUM, False, la.group)
    _reduce_in_place(y, ReduceOp.SUM, False, ca.group)
    if op == ReduceOp.AVERAGE:
        y = _divide_by_size(y, la.size * ca.size)
    return y


def hierarchical_allreduce_staged(x: torch.Tensor,
                                  op: ReduceOp = ReduceOp.AVERAGE,
                                  local_axis="local", cross_axis="cross"
                                  ) -> torch.Tensor:
    """Reduce-scatter over the local axis, allreduce of the shard over
    the cross axis, allgather over the local axis: the cross hop carries
    1/local of the bytes. dim 0 must divide by the local size."""
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("supports SUM/AVERAGE")
    la, ca = _axis(local_axis), _axis(cross_axis)
    shard = reducescatter(x, ReduceOp.SUM, la)
    _reduce_in_place(shard, ReduceOp.SUM, False, ca.group)
    y = allgather(shard, la)
    if op == ReduceOp.AVERAGE:
        y = _divide_by_size(y, la.size * ca.size)
    return y


def hierarchical_allgather(x: torch.Tensor, local_axis="local",
                           cross_axis="cross") -> torch.Tensor:
    """Allgather within the host, then across hosts: the flat
    allgather's rows, in the flat order."""
    return allgather(allgather(x, local_axis), cross_axis)


def quantized_hierarchical_allreduce(x: torch.Tensor,
                                     op: ReduceOp = ReduceOp.AVERAGE,
                                     local_axis="local",
                                     cross_axis="cross") -> torch.Tensor:
    """The EQuARX-style staged allreduce with int8 on both cross hops
    (``horovod_tpu/ops/collectives.py:495-585``): reduce-scatter over the
    local axis in the native dtype; the shard cut into one chunk per
    cross rank, each quantized with K2 (one grouped launch), exchanged
    (``all_to_all``) with its scales, the received chunks dequantized
    with K4 (one grouped launch) and summed in rank order; the reduced
    chunk requantized (K2), gathered across hosts and dequantized (K4);
    then an allgather over the local axis. dim 0 of ``x`` must divide by
    the local size. Per element the error is at most half a block scale
    of each cross rank's chunk plus half of the reduced chunk's."""
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("supports SUM/AVERAGE")
    la, ca = _axis(local_axis), _axis(cross_axis)
    nl, nc = la.size, ca.size
    shard = reducescatter(x, ReduceOp.SUM, la)
    flat = shard.reshape(-1)
    chunk = -(-flat.numel() // nc)
    chunks = torch.nn.functional.pad(
        flat, (0, chunk * nc - flat.numel())).reshape(nc, chunk)
    coded = kernels.quantize_int8_group(list(chunks))
    q = torch.stack([c[0] for c in coded])
    sc = torch.stack([c[1] for c in coded])
    qx, sx = all_to_all(q, ca), all_to_all(sc, ca)

    def dequantize(qs, ss):
        out = torch.empty((nc, chunk), dtype=torch.float32,
                          device=flat.device)
        kernels.dequantize_int8_into(
            [(qs[i], ss[i], chunk) for i in range(nc)], list(out))
        return out

    parts = dequantize(qx, sx)
    own = parts[0].clone()
    for i in range(1, nc):
        own += parts[i]
    qr, sr, _ = kernels.quantize_int8(own)
    gathered = dequantize(all_gather_stack(qr, ca), all_gather_stack(sr, ca))
    reduced = gathered.reshape(-1)[:shard.numel()].reshape(shard.shape)
    y = allgather(reduced.to(x.dtype), la)
    if op == ReduceOp.AVERAGE:
        y = _divide_by_size(y, nl * nc)
    return y


# -- the topology-aware router ------------------------------------------------
#
# The JAX package's WirePlan router (collectives.py:823-1330): an ordered
# list of (axis, wire) phases, fast axis first. mesh_allreduce
# reduce-scatters down the fast axes, reduces over the last (slowest)
# axis and all-gathers back up, each hop in its axis's wire format, so
# the slow axis carries 1/prod(fast sizes) of the bytes, in int8 where
# the plan says so. Here each phase is a collective over its axis's
# subgroup, run to its end before the next.

# Telemetry: per-axis wire bytes of each routed allreduce (the eager
# engine's family, axis="flat" there).
_METRICS_ON = metrics_lib.enabled()
_M_AXIS_BYTES = metrics_lib.counter(
    "hvd_tpu_allreduce_bytes_total",
    "allreduce bytes on the wire by wire format and mesh axis "
    "(axis=flat: eager per-call accounting; int8 includes the "
    "per-4096-block fp32 scales)",
    labels=("wire", "axis"))


@dataclasses.dataclass(frozen=True)
class AxisPhase:
    """One phase of a routing plan: its axis and the wire format its hops
    carry (``"none"`` native, ``"bf16"`` cast, ``"int8"`` block-scaled;
    ``"fp32"`` is an alias of ``"none"``)."""

    axis: str
    wire: str = "none"

    def __post_init__(self):
        if self.wire == "fp32":
            object.__setattr__(self, "wire", "none")
        if self.wire not in WIRES:
            raise ValueError(
                f"unknown wire format {self.wire!r} for axis "
                f"{self.axis!r}; choose from {WIRES}")


@dataclasses.dataclass(frozen=True)
class WirePlan:
    """Ordered per-axis routing plan, FAST axis first, slowest last (the
    JAX package's, copied). Built from a spec (``"local:none,cross:int8"``),
    from :meth:`hierarchical`, or from :class:`AxisPhase` tuples."""

    phases: Tuple[AxisPhase, ...]

    def __post_init__(self):
        if not self.phases:
            raise ValueError("WirePlan needs at least one axis phase")
        names = [p.axis for p in self.phases]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate axes in WirePlan: {names}")

    @classmethod
    def parse(cls, spec: str) -> "WirePlan":
        """``"local:none,cross:int8"`` (fast -> slow; an axis alone rides
        ``none``)."""
        phases = []
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            if ":" in part:
                axis, wire = part.split(":", 1)
                phases.append(AxisPhase(axis.strip(), wire.strip()))
            else:
                phases.append(AxisPhase(part))
        return cls(tuple(phases))

    @classmethod
    def hierarchical(cls, local_axis: str = "local",
                     cross_axis: str = "cross", cross_wire: str = "none",
                     local_wire: str = "none") -> "WirePlan":
        """The 2-D plan: the local axis first, the cross axis last."""
        return cls((AxisPhase(local_axis, local_wire),
                    AxisPhase(cross_axis, cross_wire)))

    @classmethod
    def resolve(cls, value, local_axis: str = "local",
                cross_axis: str = "cross") -> Optional["WirePlan"]:
        """A route value as a plan, or None for the flat axis: a plan, a
        spec string, phase tuples, or ``"flat"``/``"staged"``/
        ``"staged_int8"``."""
        if value is None:
            return None
        if isinstance(value, WirePlan):
            return value
        if isinstance(value, (list, tuple)):
            return cls(tuple(p if isinstance(p, AxisPhase)
                             else AxisPhase(*p) for p in value))
        name = str(value).strip()
        if name in ("", "flat", "none"):
            return None
        if name in ("staged", "hierarchical"):
            return cls.hierarchical(local_axis, cross_axis)
        if name in ("staged_int8", "quantized_cross", "mesh_int8"):
            return cls.hierarchical(local_axis, cross_axis,
                                    cross_wire="int8")
        if ":" in name or "," in name:
            return cls.parse(name)
        raise ValueError(
            f"unknown route {value!r}: pass a WirePlan, a spec like "
            "'local:none,cross:int8', or one of "
            "'flat'/'staged'/'staged_int8'")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(p.axis for p in self.phases)

    @property
    def wires(self) -> Tuple[str, ...]:
        return tuple(p.wire for p in self.phases)

    def with_wires(self, wire: str) -> "WirePlan":
        """The same axes, one wire format everywhere."""
        return WirePlan(tuple(AxisPhase(p.axis, wire) for p in self.phases))

    def reversed(self) -> "WirePlan":
        """The phases in reverse: the plan whose :func:`mesh_allgather`
        inverts a :func:`mesh_reducescatter` shard layout."""
        return WirePlan(tuple(reversed(self.phases)))

    def describe(self) -> str:
        return ",".join(f"{p.axis}:{p.wire}" for p in self.phases)


def _wire_elem_bytes(wire: str, itemsize: int) -> float:
    """Wire bytes an element: int8 1 plus one fp32 scale per 4096; bf16
    2; none the native itemsize."""
    if wire == "int8":
        return 1.0 + 4.0 / _Q_BLOCK
    if wire == "bf16":
        return 2.0
    return float(itemsize)


def mesh_wire_cost(plan: WirePlan, nelems: int, axis_sizes: Sequence[int],
                   op: ReduceOp = ReduceOp.SUM, itemsize: int = 4) -> dict:
    """Bytes one rank sends on each axis for a routed allreduce of
    ``nelems`` elements, counted as a ring moves them: a reduce-scatter
    or an all-gather over n ranks moves (n-1)/n of its buffer, the last
    axis's allreduce both, ADASUM's last axis the whole shard once a
    level. Returns ``{axis: {"wire", "bytes", "size"}, "total": ...}``."""
    sizes = list(axis_sizes)
    if len(sizes) != len(plan.phases):
        raise ValueError("axis_sizes must parallel plan.phases")
    out = {}
    length, total = float(nelems), 0.0
    for p, n in zip(plan.phases[:-1], sizes[:-1]):
        b = 2.0 * (n - 1) / n * length * _wire_elem_bytes(p.wire, itemsize)
        out[p.axis] = {"wire": p.wire, "bytes": b, "size": n}
        total += b
        length /= n
    last, n = plan.phases[-1], sizes[-1]
    eb = _wire_elem_bytes(last.wire, itemsize)
    if ReduceOp(op) == ReduceOp.ADASUM:
        b = math.log2(n) * length * eb if n > 1 else 0.0
    else:
        b = 2.0 * (n - 1) / n * length * eb
    out[last.axis] = {"wire": last.wire, "bytes": b, "size": n}
    out["total"] = total + b
    return out


def _count_mesh_bytes(plan: WirePlan, nelems: int, ns, op) -> None:
    if not _METRICS_ON:
        return
    cost = mesh_wire_cost(plan, nelems, ns, op)
    for p in plan.phases:
        _M_AXIS_BYTES.labels(wire=p.wire, axis=p.axis).inc(
            cost[p.axis]["bytes"])


def _plan_or_flat(plan) -> WirePlan:
    return WirePlan.resolve(plan) or WirePlan.parse("hvd")


def mesh_reducescatter(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                       plan=None, key=None, return_residual: bool = False):
    """Staged reduce-scatter of a 1-D buffer: one over each plan axis in
    order (fast first), each in its wire. The length must divide by the
    mesh size (times 4096 per rank where a phase rides int8). Returns
    this rank's reduced chunk, fast-axis-major, so that
    ``mesh_allgather(chunk, plan.reversed())`` inverts it; with
    ``return_residual`` also this rank's full-length fp32 error of the
    int8 phases, each landing on the shard it belongs to (summed over
    the mesh it is the pending correction)."""
    plan = _plan_or_flat(plan)
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("mesh_reducescatter supports SUM/AVERAGE")
    buf, total, off = x, 1, 0
    residual = torch.zeros(x.shape[0], dtype=torch.float32,
                           device=x.device) if return_residual else None
    for i, p in enumerate(plan.phases):
        ax = _axis(p.axis)
        total *= ax.size
        if p.wire == "int8":
            rs = quantized_reducescatter(
                buf.to(torch.float32), ReduceOp.SUM,
                key=None if key is None else fold_in(key, i),
                return_residual=return_residual, axis=ax)
            shard, err = rs if return_residual else (rs, None)
            if err is not None:
                residual[off:off + err.numel()] += err
            buf = shard.to(x.dtype)
        elif p.wire == "bf16":
            buf = reducescatter(buf.to(torch.bfloat16), ReduceOp.SUM,
                                ax).to(x.dtype)
        else:
            buf = reducescatter(buf, ReduceOp.SUM, ax)
        off += ax.index * buf.numel()
    if op == ReduceOp.AVERAGE:
        buf = _divide_by_size(buf, total)
    return (buf, residual) if return_residual else buf


def mesh_allgather(x: torch.Tensor, plan=None, key=None,
                   return_residual: bool = False, first_hop: int = 0):
    """Staged all-gather along dim 0: one over each plan axis in order,
    each in its wire (int8 quantized per 4096-block, lossy; K2, or K3
    from ``key`` folded by ``first_hop`` plus the phase index). With the
    slow axis first in rank order, a fast-first plan gives the flat
    allgather's rows in the flat order.

    ``return_residual=True`` also returns this rank's fp32 rounding error
    of the int8 hops, in the output's shape, each hop's error on the rows
    its shard lands on. A hop's shard is the same on every rank of the
    axes gathered before it, so the rank at index 0 of each carries it:
    summed over the plan's ranks every error counts once."""
    plan = _plan_or_flat(plan)
    axes = [_axis(p.axis) for p in plan.phases]
    out = x
    residual = None
    if return_residual:
        residual = torch.zeros(x.numel() * math.prod(a.size for a in axes),
                               dtype=torch.float32, device=x.device)
    for i, (p, ax) in enumerate(zip(plan.phases, axes)):
        shape, size = out.shape, out.numel()
        if p.wire == "int8":
            flat = out.to(torch.float32).reshape(-1)
            q, s, _ = _quantize(flat, None if key is None
                                else fold_in(key, first_hop + i))
            if return_residual and all(a.index == 0 for a in axes[:i]):
                # This shard's place in the output: each later hop puts
                # its input block at its index times the block's length.
                at = sum(a.index * size * math.prod(b.size
                                                    for b in axes[i:k])
                         for k, a in enumerate(axes[i:], i))
                residual[at:at + size] += flat - _deq(q, s).reshape(-1)[
                    :size]
            rows = _deq(all_gather_stack(q, ax),
                        all_gather_stack(s, ax))[:, :size]
            out = rows.reshape((ax.size * shape[0],) + tuple(shape[1:])).to(
                x.dtype)
        elif p.wire == "bf16":
            out = allgather(out.to(torch.bfloat16), ax).to(x.dtype)
        else:
            out = allgather(out, ax)
    if not return_residual:
        return out
    return out, residual.reshape(out.shape)


def mesh_allreduce(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
                   plan=None, key=None, return_residual: bool = False,
                   adasum_scalar_dtype=None):
    """Topology-routed allreduce (``horovod_tpu/ops/collectives.py:1134``):
    :func:`mesh_reducescatter` down the plan's fast axes, the reduction
    over its last (slowest) axis, :func:`mesh_allgather` back up, every
    hop in its axis's wire. Any shape and dtype; every rank ends with the
    same bits.

    ``op``: SUM or AVERAGE (divided once, by the mesh size, at the end),
    or ADASUM: the fast axes are summed, the slow axis runs the
    distance-doubling recursion (K8/K9) on the shards with the dot/norm
    scalars summed over the fast axes before each combine, and the
    result is divided by the fast group size — the Adasum of the
    per-fast-group averages.

    int8 phases quantize with K2, or with K3 from ``key`` folded by the
    hop's index (descent, last axis, ascent; the same on every rank);
    each adds at most r*s an element a participating rank (s its block
    scale, r 1/2 to nearest, 1 stochastic). ``return_residual=True``
    also returns this rank's fp32 error-feedback residual (``x``'s
    shape): summed over the mesh it is the exact sum less the result,
    the descent errors on the shards they belong to, an ascent error
    carried once (by the rank at index 0 of every axis reduced below
    it)."""
    plan = WirePlan.resolve(plan)
    if plan is None:
        raise ValueError("mesh_allreduce requires a WirePlan (route)")
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.ADASUM):
        raise ValueError("mesh_allreduce supports SUM/AVERAGE/ADASUM")
    phases = plan.phases
    axes = [_axis(p.axis) for p in phases]
    ns = [a.size for a in axes]
    total = math.prod(ns)
    any_int8 = any(p.wire == "int8" for p in phases)
    orig_dtype, shape, size = x.dtype, x.shape, x.numel()
    work_dtype = torch.float32 if (any_int8 or return_residual) else x.dtype
    grid = total * (_Q_BLOCK if any_int8 else 1)
    L = -(-size // grid) * grid
    buf = torch.nn.functional.pad(x.reshape(-1).to(work_dtype),
                                  (0, L - size))
    _count_mesh_bytes(plan, L, ns, op)
    fast = WirePlan(phases[:-1]) if len(phases) > 1 else None
    residual = torch.zeros(L, dtype=torch.float32, device=x.device) \
        if return_residual else None
    if fast is not None:
        rs = mesh_reducescatter(buf, ReduceOp.SUM, fast, key=key,
                                return_residual=return_residual)
        buf, residual = rs if return_residual else (rs, None)
    # This rank's shard of the flat buffer, fast-axis-major.
    off = sum(a.index * (L // math.prod(ns[:i + 1]))
              for i, a in enumerate(axes[:-1]))
    hop = len(phases) - 1
    kc = None if key is None else fold_in(key, hop)

    last, last_ax = phases[-1], axes[-1]
    if op == ReduceOp.ADASUM:
        from . import adasum as adasum_lib

        buf = adasum_lib.adasum_allreduce(
            buf, scalar_dtype=adasum_scalar_dtype, wire=last.wire,
            key=kc, axis=last_ax, scalar_axes=tuple(axes[:-1]))
    elif last.wire == "int8":
        ar = quantized_allreduce(buf.to(torch.float32), ReduceOp.SUM,
                                 key=kc, return_residual=return_residual,
                                 axis=last_ax)
        buf, err = ar if return_residual else (ar, None)
        if err is not None:
            residual[off:off + err.numel()] += err
        buf = buf.to(work_dtype)
    elif last.wire == "bf16":
        buf = allreduce(buf.to(torch.bfloat16), ReduceOp.SUM,
                        axis=last_ax).to(work_dtype)
    else:
        buf = allreduce(buf, ReduceOp.SUM, axis=last_ax)

    if fast is not None:
        # The shard is the same on every rank of the last axis: the rank
        # at its index 0 carries the ascent's errors.
        ag = mesh_allgather(buf, fast.reversed(), key=key,
                            return_residual=return_residual,
                            first_hop=hop + 1)
        buf, err = ag if return_residual else (ag, None)
        if err is not None and last_ax.index == 0:
            residual += err

    if op == ReduceOp.AVERAGE:
        buf = _divide_by_size(buf, total)
        if not orig_dtype.is_floating_point:
            orig_dtype = buf.dtype
    elif op == ReduceOp.ADASUM and len(phases) > 1:
        buf = _divide_by_size(buf, total // ns[-1])
    y = buf[:size].reshape(shape).to(orig_dtype)
    if not return_residual:
        return y
    return y, residual[:size].reshape(shape)


# -- wired exchanges ----------------------------------------------------------

def _ppermute_wire(x: torch.Tensor, axis, perm, wire: str, key
                   ) -> torch.Tensor:
    """One permutation hop in a wire format: ``none`` native, ``bf16``
    cast around it, ``int8`` block-scaled codes (K2, or K3 with a key)
    and their scales, dequantized on arrival (plain ``_deq``, as the JAX
    package's is plain jnp). Zero rows stay exact zeros in every
    format."""
    if wire == "bf16":
        return ppermute(x.to(torch.bfloat16), perm, axis).to(x.dtype)
    if wire == "int8":
        size = x.numel()
        flat = x.to(torch.float32).reshape(-1)
        q, s = _int8_chunks(torch.nn.functional.pad(
            flat, (0, -size % _Q_BLOCK)), 1, key)
        got = _deq(ppermute(q[0], perm, axis), ppermute(s[0], perm, axis))
        return got[:size].reshape(x.shape).to(x.dtype)
    return ppermute(x, perm, axis)


class _WiredPermute(torch.autograd.Function):
    """A wired hop whose backward sends the cotangent along the inverse
    permutation in the same wire — the straight-through gradient of the
    JAX package's ``_int8_ppermute`` (its key folded by 0x5714), and for
    the none and bf16 wires the exact vjp."""

    @staticmethod
    def forward(ctx, x, axis, perm, wire, key):
        ctx.axis, ctx.perm, ctx.wire, ctx.key = axis, perm, wire, key
        return _ppermute_wire(x, axis, perm, wire, key)

    @staticmethod
    def backward(ctx, g):
        kb = None if ctx.key is None else fold_in(ctx.key, 0x5714)
        inv = [(d, s) for s, d in ctx.perm]
        return (_ppermute_wire(g.contiguous(), ctx.axis, inv, ctx.wire, kb),
                None, None, None, None)


def wired_ppermute(x: torch.Tensor, axis, perm, wire: str = "none",
                   key=None) -> torch.Tensor:
    """A :func:`ppermute` hop in a wire format (``none``, ``bf16``,
    ``int8``), differentiable: the gradient rides the inverse
    permutation in the same wire (straight through the int8 rounding).
    Integer payloads ride uncompressed; ``key`` makes int8 roundings
    stochastic."""
    if wire not in WIRES:
        raise ValueError(f"unknown wire format {wire!r}; choose from "
                         f"{WIRES}")
    if wire != "none" and not x.is_floating_point():
        wire = "none"
    ax = _axis(axis)
    perm = [(int(s), int(d)) for s, d in perm]
    if torch.is_grad_enabled() and x.requires_grad:
        return _WiredPermute.apply(x, ax, perm, wire, key)
    return _ppermute_wire(x, ax, perm, wire, key)


def alltoallv_chunked(x: torch.Tensor, splits_matrix, axis=None,
                      wire: str = "none", key=None):
    """Uneven all-to-all in n-1 permutation hops, each padded only to its
    own largest segment (``horovod_tpu/ops/collectives.py:330-441``):
    hop ``k`` carries every rank's segment for destination ``(r+k) % n``
    in ``b_k = max_r splits[r][(r+k) % n]`` rows, so skewed tables move
    about ``max + (n-1) * mean`` rows, not ``n * max``. The self segment
    never touches the wire.

    ``x``: this rank's rows as consecutive destination segments, padded
    with zero rows at the end to ``max_r sum(splits[r])`` (the same on
    every rank); ``splits_matrix[s][d]`` the rows rank ``s`` sends to
    ``d`` (every rank passes the same table). Returns ``(recv,
    recv_counts)``: one segment of ``max(splits)`` rows per source,
    source-major, the first ``splits[s][me]`` rows valid and the rest
    zeros; ``recv_counts`` the valid counts. Each hop rides
    :func:`wired_ppermute` in ``wire`` (key folded by the hop), so
    gradients flow through."""
    if wire not in WIRES:
        raise ValueError(f"unknown wire format {wire!r}; choose from "
                         f"{WIRES}")
    if wire != "none" and not x.is_floating_point():
        wire = "none"
    ax = _axis(axis)
    n, me = len(splits_matrix), ax.index
    if ax.size != n:
        raise ValueError(f"splits matrix is {n}x{n} but axis {ax.name!r} "
                         f"has {ax.size} ranks")
    rest = tuple(x.shape[1:])
    max_send = max(sum(row) for row in splits_matrix)
    if x.shape[0] < max_send:
        raise ValueError(f"send buffer has {x.shape[0]} rows; every rank "
                         f"pads to the max per-rank row sum {max_send}")
    seg = max(max(max(row) for row in splits_matrix), 1)
    x = torch.cat([x, x.new_zeros((seg,) + rest)])
    send_off = [sum(splits_matrix[me][:d]) for d in range(n)]

    def chunk(dst, rows):
        piece = x[send_off[dst]:send_off[dst] + rows]
        valid = splits_matrix[me][dst]
        if valid < rows:
            piece = torch.cat([piece[:valid],
                               piece.new_zeros((rows - valid,) + rest)])
        return piece

    def padded(piece):
        return torch.cat([piece, piece.new_zeros(
            (seg - piece.shape[0],) + rest)]) if piece.shape[0] < seg \
            else piece

    pieces = [x.new_zeros((seg,) + rest) for _ in range(n)]
    b0 = max(splits_matrix[r][r] for r in range(n))
    if b0:
        pieces[me] = padded(chunk(me, b0))
    for k in range(1, n):
        bk = max(splits_matrix[r][(r + k) % n] for r in range(n))
        if bk == 0:
            continue
        got = wired_ppermute(chunk((me + k) % n, bk), ax,
                             [(r, (r + k) % n) for r in range(n)], wire,
                             None if key is None else fold_in(key, k))
        pieces[(me - k) % n] = padded(got)
    counts = torch.tensor([splits_matrix[s][me] for s in range(n)],
                          dtype=torch.int32)
    return torch.cat(pieces), counts
