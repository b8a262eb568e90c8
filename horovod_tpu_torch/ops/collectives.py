"""Collective primitives of the port over ``torch.distributed`` — the
per-process counterparts of ``horovod_tpu/ops/collectives.py``.

The JAX functions reduce over a mesh axis inside a traced program; here
every call is an eager collective over the default process group that
``common.basics.init()`` set up (NCCL on the card, gloo on the CPU or
with ``init(backend="gloo")``). Results are new tensors unless a name
ends in ``_`` (in place).

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
the error-feedback residual). The hierarchical/mesh-routed reductions
come with a later slice.

A collective the eager engine runs asynchronously comes as an
``*_issue`` function returning :data:`Issued` — the works in flight and
the step that finishes the result after them (a division, a postscale,
a decompression); the blocking form waits at once.

Every collective here is one that gloo also runs on CUDA tensors
(staging them through host memory): ``all_reduce``, ``broadcast``,
``all_gather`` (the list form) and ``all_to_all_single`` (with split
sizes too). A reduce-scatter is an ``all_to_all_single`` and a sum in
rank order; a ragged gather pads to the longest rank. A pairwise
exchange (:func:`pair_exchange`) is an ``all_to_all_single`` whose split
sizes are zero except toward the partner, since gloo's ``send``/``recv``
do not take CUDA tensors. The same calls run over NCCL when each rank
has its own GPU.

Stochastic rounding keys are tuples of ints (the JAX package's
``jax.random`` keys): :func:`fold_in` appends one, and the thresholds of
a quantization are ``torch.rand`` draws from a generator seeded by a hash
of the key, so every rank draws the same ``u`` for the same key, as
every SPMD rank of the JAX package does. The draws differ from
``jax.random``'s.
"""

from __future__ import annotations

import enum
import hashlib
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..common import basics
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


def _reduce_in_place(x: torch.Tensor, op: ReduceOp, async_op: bool):
    if op == ReduceOp.ADASUM:
        raise ValueError("Adasum is no in-place sum: call allreduce(x, "
                         "op=Adasum)")
    dist_op = _DIST_OP.get(ReduceOp.SUM if op == ReduceOp.AVERAGE else op)
    if dist_op is None:
        raise ValueError(f"unsupported reduce op: {op}")
    return dist.all_reduce(x, op=dist_op, async_op=async_op)


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
                    postscale_factor: float = 1.0) -> Issued:
    """:func:`allreduce`, issued: the prescale and the reduction are
    queued; the division (AVERAGE) and the postscale run at the finish.
    ADASUM runs to its end here."""
    op = ReduceOp(op)
    n = basics.size()
    y = _apply_scale(x, prescale_factor)
    if op == ReduceOp.ADASUM:
        from . import adasum as adasum_lib

        y = adasum_lib.adasum_allreduce(y)
        return _done(_apply_scale(x.clone() if y is x else y,
                                  postscale_factor))
    y = _owned(x, y)
    work = _reduce_in_place(y, op, async_op=True)

    def finish():
        z = _divide_by_size(y, n) if op == ReduceOp.AVERAGE else y
        return _apply_scale(z, postscale_factor)
    return [work], finish


def allreduce(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """Allreduce of ``x`` across all ranks; returns a new tensor.
    AVERAGE is a SUM followed by an exact division by the world size;
    PRODUCT, MIN and MAX reduce elementwise; ADASUM is
    ``adasum.adasum_allreduce`` with the configured scalar dtype
    (``HVD_TPU_ADASUM_SCALAR_DTYPE``)."""
    return wait_issued(allreduce_issue(x, op, prescale_factor,
                                       postscale_factor))


def _allreduce_async_inplace(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM):
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
    basics.context()
    return _reduce_in_place(x, op, async_op=True)


def join_allreduce(x: torch.Tensor, joined: bool, active: int,
                   op: ReduceOp = ReduceOp.AVERAGE) -> torch.Tensor:
    """Allreduce in which a rank that has joined contributes zeros and
    AVERAGE divides by the ``active`` ranks (at least 1) — the reference's
    JoinOp, ``horovod_tpu/ops/collectives.py`` ``join_allreduce``. Every
    rank passes the same ``active`` (the join round tells it)."""
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("join supports SUM/AVERAGE")
    y = torch.zeros_like(x) if joined else _owned(x, x)
    _reduce_in_place(y, ReduceOp.SUM, async_op=False)
    if op == ReduceOp.AVERAGE:
        y = _divide_by_size(y, max(active, 1))
    return y


def allgather_issue(x: torch.Tensor) -> Issued:
    """:func:`allgather`, issued."""
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(basics.size())]
    work = dist.all_gather(parts, x.contiguous(), async_op=True)
    return [work], lambda: torch.cat(parts, dim=0)


def allgatherv_issue(x: torch.Tensor, sizes: Sequence[int]) -> Issued:
    """Ragged allgather: rank ``r`` holds ``sizes[r]`` rows (the table
    every rank agrees on, ``horovod_tpu/ops/collectives.py``
    ``allgatherv``); the result is every rank's rows in rank order. Each
    buffer is zero-padded to ``max(sizes)`` rows and gathered with the
    even list-form ``all_gather`` (which gloo runs on CUDA tensors)."""
    n = basics.size()
    me = basics.rank()
    if len(sizes) != n or x.shape[0] != sizes[me]:
        raise ValueError(f"allgatherv: rank {me} holds {x.shape[0]} rows; "
                         f"the size table says {list(sizes)}")
    maxs = max(sizes)
    padded = x.new_zeros((maxs,) + tuple(x.shape[1:]))
    padded[:x.shape[0]] = x
    parts = [torch.empty_like(padded) for _ in range(n)]
    work = dist.all_gather(parts, padded, async_op=True)
    return [work], lambda: torch.cat(
        [p[:k] for p, k in zip(parts, sizes)], dim=0)


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


def broadcast_issue(x: torch.Tensor, root_rank: int = 0) -> Issued:
    """``root_rank``'s value of ``x`` as a new tensor, issued."""
    y = _owned(x, x)
    work = dist.broadcast(y, src=root_rank, async_op=True)
    return [work], lambda: y


# -- exchanges ----------------------------------------------------------------

def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """Rank ``j`` receives block ``j`` of every rank's ``x`` (blocks along
    dim 0, one per rank), stacked in rank order."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous())
    return out


def all_gather_stack(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked along a new leading dim, in rank order
    (the list form of ``all_gather``, which gloo runs on CUDA tensors)."""
    parts = [torch.empty_like(x) for _ in range(basics.size())]
    dist.all_gather(parts, x.contiguous())
    return torch.stack(parts)


def pair_exchange(x: torch.Tensor, partner: int) -> torch.Tensor:
    """``partner``'s ``x`` (same shape and dtype on both sides), while
    ``partner`` receives this rank's: an ``all_to_all_single`` with every
    split zero but the partner's. Every rank of the world must call it in
    the same step (each with its own partner)."""
    n = basics.size()
    flat = x.contiguous().reshape(-1)
    splits = [0] * n
    splits[partner] = flat.numel()
    out = torch.empty_like(flat)
    dist.all_to_all_single(out, flat, output_split_sizes=splits,
                           input_split_sizes=splits)
    return out.reshape(x.shape)


def _even_rows(x: torch.Tensor, n: int, what: str) -> int:
    if x.dim() == 0 or x.shape[0] % n:
        raise ValueError(f"{what}: dim 0 ({tuple(x.shape)[:1]}) must divide "
                         f"into {n} chunks")
    return x.shape[0] // n


def alltoall_issue(x: torch.Tensor) -> Issued:
    """Even all-to-all (``horovod_tpu/ops/collectives.py`` ``alltoall``):
    dim 0 splits into ``n`` equal chunks, chunk ``j`` goes to rank ``j``,
    and the received chunks concatenate along dim 0 in rank order."""
    _even_rows(x, basics.size(), "alltoall")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    work = dist.all_to_all_single(out, xc, async_op=True)
    return [work], lambda: out


def alltoallv_issue(x: torch.Tensor, splits: Sequence[int],
                    recv_splits: Sequence[int]) -> Issued:
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
                                  input_split_sizes=splits, async_op=True)
    return [work], lambda: out


WIRES = ("none", "bf16", "int8")


def compressed_alltoall_issue(x: torch.Tensor, wire: str = "int8"
                              ) -> Issued:
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
    n = basics.size()
    m = _even_rows(x, n, "compressed_alltoall")
    if n == 1 or wire == "none" or not x.is_floating_point():
        return alltoall_issue(x)
    if wire == "bf16":
        works, finish = alltoall_issue(x.to(torch.bfloat16))
        return works, lambda: finish().to(x.dtype)
    rest = tuple(x.shape[1:])
    c = x.numel() // n
    pad = -c % _Q_BLOCK
    chunks = x.reshape(n, c).to(torch.float32)
    flat = torch.nn.functional.pad(chunks, (0, pad)).reshape(-1)
    q, s = _int8_chunks(flat, n, None)
    q, s = q.reshape(-1, q.shape[-1]), s.reshape(-1)
    qx, sx = torch.empty_like(q), torch.empty_like(s)
    works = [dist.all_to_all_single(qx, q, async_op=True),
             dist.all_to_all_single(sx, s, async_op=True)]
    deq_dtype = x.dtype if x.dtype in (torch.float32, torch.bfloat16) \
        else torch.float32

    def finish():
        out = kernels.dequantize_int8(qx, sx, flat.numel(), (n, c + pad),
                                      deq_dtype)
        return out[:, :c].to(x.dtype).reshape((n * m,) + rest)
    return works, finish


def reducescatter_issue(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM
                        ) -> Issued:
    """Reduce-scatter along dim 0 (``horovod_tpu/ops/collectives.py``
    ``reducescatter``): this rank's 1/n slice of the elementwise SUM (or
    AVERAGE) over ranks. One ``all_to_all_single`` brings every rank's
    copy of this rank's slice here; they are summed in rank order, the
    same on NCCL and on gloo (whose ``reduce_scatter`` is not used)."""
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("reducescatter supports SUM/AVERAGE")
    n = basics.size()
    m = _even_rows(x, n, "reducescatter")
    works, exchanged = alltoall_issue(x)

    def finish():
        parts = exchanged().reshape((n, m) + tuple(x.shape[1:]))
        acc = parts[0].clone()
        for src in range(1, n):
            acc += parts[src]
        return _divide_by_size(acc, n) if op == ReduceOp.AVERAGE else acc
    return works, finish


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
                            key=None, return_residual: bool = False):
    """Reduce-scatter of a flat buffer with an int8 payload on the wire.

    ``x`` is 1-D with ``x.shape[0] % (n * 4096) == 0`` (zero-pad: pads
    quantize to exact 0). Returns this rank's reduced chunk of
    ``x.shape[0] // n`` elements in ``x.dtype``; with
    ``return_residual=True`` also the full-length fp32 local quantization
    error ``x - dequant(quant(x))``."""
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("quantized reducescatter supports SUM/AVERAGE")
    n = basics.size()
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
        own = _deq(all_to_all(q), all_to_all(s)).sum(dim=0)
    if op == ReduceOp.AVERAGE:
        own = _divide_by_size(own, n)
    if not return_residual:
        return own.to(x.dtype)
    return own.to(x.dtype), flat - _deq(q, s).reshape(flat.shape)


def quantized_allreduce(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
                        key=None, return_residual: bool = False):
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
    n = basics.size()
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
                                 return_residual=return_residual)
    own, residual = rs if return_residual else (rs, None)
    kr = None if key is None else fold_in(key, 1)
    qr, sr = _int8_chunks(own, 1, kr)
    red = _deq(all_gather_stack(qr[0]), all_gather_stack(sr[0]))
    y = red.reshape(-1)[:size].reshape(x.shape)
    if op == ReduceOp.AVERAGE:
        y = _divide_by_size(y, n)
    y = y.to(x.dtype)
    if not return_residual:
        return y
    # The requantize error of the owned chunk joins this rank's residual:
    # residuals are summed across ranks through the next step's
    # reduction, so the owner carrying it corrects the sum just the same.
    me = basics.rank()
    residual[me * chunk:(me + 1) * chunk] += own - _deq(qr[0], sr[0])
    return y, residual[:size].reshape(x.shape)
