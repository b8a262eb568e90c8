"""Tensor fusion — bucketing many small tensors into few flat buffers.

The port of ``horovod_tpu/common/fusion.py``'s planner and its fuse /
unfuse pair. A plan is a deterministic function of the leaves' shapes,
dtypes, the byte threshold and the visit order, so every rank computes
the same plan without negotiation. Leaves are a sequence of tensors (the
JAX package flattens a pytree; the port takes its leaves in the order
the caller gives, e.g. ``model.parameters()``).

``plan_fusion`` is the JAX package's planner: the native one
(``native/fusion_planner.cc``, with :func:`_plan_python` as its mirror
under ``HVD_TPU_DISABLE_NATIVE=1``), greedy same-dtype buckets up to the
threshold, in ``order`` (``"flatten"``,
``"reverse"`` or an explicit permutation). Under a readiness order
(``"reverse"``/explicit) buckets come out in CLOSING order — sorted by
the visit position of their last leaf — so issuing collectives in bucket
order issues them as the gradients complete during backprop.
``assign_wire_dtypes`` stamps each bucket's wire format for the int8_ef
reduction, with the JAX package's decisions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch

from . import metrics as metrics_lib

ORDER_FLATTEN = "flatten"
ORDER_REVERSE = "reverse"

_M_PLANS = metrics_lib.counter(
    "hvd_tpu_fusion_plans_total", "fusion bucket plans computed")
_M_BUCKETS = metrics_lib.gauge(
    "hvd_tpu_fusion_buckets", "bucket count of the most recent plan")
_M_FILL = metrics_lib.gauge(
    "hvd_tpu_fusion_fill_efficiency",
    "mean bucket fill fraction (bucket bytes / threshold) of the most "
    "recent plan")
_METRICS_ON = metrics_lib.enabled()
_M_WIRE_BUCKETS = metrics_lib.counter(
    "hvd_tpu_fusion_bucket_wire_total",
    "fusion buckets by the wire format assign_wire_dtypes stamped",
    labels=("wire",))
_M_WIRE_BYTES = metrics_lib.counter(
    "hvd_tpu_fusion_wire_bytes_total",
    "bytes planned onto each wire format (per plan, raw-dtype bytes of "
    "the buckets routed there)",
    labels=("wire",))


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One fusion bucket: indices of the leaves it covers (in the
    caller's leaf order), their shapes, and the flat element count."""

    leaf_indices: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtype: Any
    total_elems: int


@dataclasses.dataclass(frozen=True)
class FusionPlan:
    buckets: Tuple[Bucket, ...]
    num_leaves: int
    order: str = ORDER_FLATTEN
    # Per-bucket wire format of the quantized reduction, parallel to
    # ``buckets`` (WIRE_INT8/WIRE_BF16/WIRE_NONE); None until
    # :func:`assign_wire_dtypes` stamps the plan.
    wire_dtypes: Optional[Tuple[str, ...]] = None


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _resolve_order(num_leaves: int,
                   order: Union[str, Sequence[int], None]) -> List[int]:
    if order is None or order == ORDER_FLATTEN:
        return list(range(num_leaves))
    if order == ORDER_REVERSE:
        return list(range(num_leaves - 1, -1, -1))
    perm = [int(i) for i in order]
    if sorted(perm) != list(range(num_leaves)):
        raise ValueError(
            f"order must be '{ORDER_FLATTEN}', '{ORDER_REVERSE}', or a "
            f"permutation of range({num_leaves}); got {order!r}")
    return perm


def _plan_python(visit, elem_counts, itemsizes, dtypes,
                 threshold_bytes: int) -> List[int]:
    """The planner in Python (``HVD_TPU_DISABLE_NATIVE=1``), the mirror
    of ``native/fusion_planner.cc``: bucket ids in visit order."""
    open_buckets = {}  # dtype -> [bucket_id, bytes_used]
    next_bucket = 0
    bucket_ids = []
    for i in visit:
        nbytes = elem_counts[i] * itemsizes[i]
        o = open_buckets.get(dtypes[i])
        if o is None:
            open_buckets[dtypes[i]] = [next_bucket, nbytes]
            bucket_ids.append(next_bucket)
            next_bucket += 1
            continue
        if o[1] > 0 and o[1] + nbytes > threshold_bytes:
            o[0] = next_bucket
            next_bucket += 1
            o[1] = 0
        o[1] += nbytes
        bucket_ids.append(o[0])
    return bucket_ids


def plan_fusion(leaves: Sequence[torch.Tensor], threshold_bytes: int,
                order: Union[str, Sequence[int], None] = ORDER_FLATTEN
                ) -> FusionPlan:
    """Greedy same-dtype bucketing of ``leaves`` in ``order``: a bucket
    takes leaves of its dtype until the next would push it past
    ``threshold_bytes`` (a leaf larger than the threshold gets a bucket
    of its own)."""
    shapes = [tuple(int(d) for d in t.shape) for t in leaves]
    elem_counts = [_numel(s) for s in shapes]
    itemsizes = [t.element_size() for t in leaves]
    dtypes = [t.dtype for t in leaves]
    visit = _resolve_order(len(leaves), order)
    codes = {}
    for i in visit:
        codes.setdefault(dtypes[i], len(codes))

    from ..native import plan_fusion_native

    bucket_ids = plan_fusion_native([elem_counts[i] for i in visit],
                                    [codes[dtypes[i]] for i in visit],
                                    [itemsizes[i] for i in visit],
                                    threshold_bytes)
    if bucket_ids is None:
        bucket_ids = _plan_python(visit, elem_counts, itemsizes, dtypes,
                                  threshold_bytes)

    by_bucket = {}
    close_pos = {}
    for pos, b in enumerate(bucket_ids):
        by_bucket.setdefault(b, []).append(visit[pos])
        close_pos[b] = pos
    readiness = not (order is None or order == ORDER_FLATTEN)
    key = (lambda kv: (close_pos[kv[0]], kv[0])) if readiness \
        else (lambda kv: kv[0])
    buckets = tuple(
        Bucket(tuple(idxs), tuple(shapes[i] for i in idxs), dtypes[idxs[0]],
               sum(elem_counts[i] for i in idxs))
        for _, idxs in sorted(by_bucket.items(), key=key))
    order_tag = order if isinstance(order, str) and order in (
        ORDER_FLATTEN, ORDER_REVERSE) else "explicit"
    _M_PLANS.inc()
    _M_BUCKETS.set(len(buckets))
    if buckets and threshold_bytes > 0:
        fills = [min(1.0, b.total_elems * leaves[b.leaf_indices[0]]
                     .element_size() / threshold_bytes) for b in buckets]
        _M_FILL.set(sum(fills) / len(fills))
    return FusionPlan(buckets, len(leaves), order=order_tag)


# Wire formats a bucket can ride in a quantized reduction.
WIRE_NONE = "none"    # native dtype (ints, half-precision small buckets)
WIRE_BF16 = "bf16"    # cast to bf16 around the collective (2x over fp32)
WIRE_INT8 = "int8"    # block-scaled int8 quantized allreduce (4x)


def assign_wire_dtypes(plan: FusionPlan, quantize_min_bytes: int,
                       small_wire: str = WIRE_BF16) -> FusionPlan:
    """Stamp per-bucket wire decisions onto a plan (the JAX package's
    rule): float buckets of at least ``quantize_min_bytes`` ride int8,
    smaller fp32/fp64 buckets ride ``small_wire``, half-precision buckets
    below the threshold and integer buckets ride uncompressed. A function
    of the plan and the threshold alone, so every rank stamps the same
    mapping."""
    wires = []
    for b in plan.buckets:
        if not b.dtype.is_floating_point:
            wires.append(WIRE_NONE)
            continue
        itemsize = torch.empty((), dtype=b.dtype).element_size()
        if b.total_elems * itemsize >= quantize_min_bytes:
            wires.append(WIRE_INT8)
        elif itemsize > 2 and small_wire:
            wires.append(small_wire)
        else:
            wires.append(WIRE_NONE)
    if _METRICS_ON:
        for b, w in zip(plan.buckets, wires):
            _M_WIRE_BUCKETS.labels(wire=w).inc()
            _M_WIRE_BYTES.labels(wire=w).inc(
                b.total_elems * torch.empty((), dtype=b.dtype).element_size())
    return dataclasses.replace(plan, wire_dtypes=tuple(wires))


#: The alltoall wire threshold outside an initialized world (the
#: configured ``quantize_min_bucket_bytes`` default).
A2A_QUANTIZE_MIN_BYTES = 64 * 1024


def assign_alltoall_wire(nbytes: int,
                         quantize_min_bytes: int = A2A_QUANTIZE_MIN_BYTES,
                         small_wire: str = WIRE_BF16) -> str:
    """Wire format of one alltoall payload of ``nbytes`` raw bytes (the
    eager ``alltoall(wire="auto")``): int8 at or above the threshold, the
    ``small_wire`` cast below it — the JAX planner's rule, the same on
    every rank without negotiation."""
    if nbytes >= quantize_min_bytes:
        return WIRE_INT8
    return small_wire or WIRE_NONE


def fuse_bucket(leaves: Sequence[torch.Tensor], bucket: Bucket
                ) -> torch.Tensor:
    """One bucket's leaves concatenated into one flat tensor."""
    parts = [leaves[i].reshape(-1) for i in bucket.leaf_indices]
    return parts[0].clone() if len(parts) == 1 else torch.cat(parts)


def fuse(leaves: Sequence[torch.Tensor], plan: FusionPlan
         ) -> List[torch.Tensor]:
    """Every bucket's leaves concatenated into one flat tensor each."""
    return [fuse_bucket(leaves, b) for b in plan.buckets]


def unfuse_bucket(flat: torch.Tensor, bucket: Bucket):
    """``(leaf index, view of flat)`` pairs of one bucket, in the
    leaves' shapes."""
    out, off = [], 0
    for i, shape in zip(bucket.leaf_indices, bucket.shapes):
        n = _numel(shape)
        out.append((i, flat[off:off + n].view(shape)))
        off += n
    return out


def unfuse(flats: Sequence[torch.Tensor], plan: FusionPlan
           ) -> List[torch.Tensor]:
    """Split flat buffers back into the leaves, in the original order."""
    leaves: List[Any] = [None] * plan.num_leaves
    for flat, b in zip(flats, plan.buckets):
        for i, t in unfuse_bucket(flat, b):
            leaves[i] = t
    return leaves


def fused_apply(leaves: Sequence[torch.Tensor], fn: Callable,
                threshold_bytes: int = 64 * 1024 * 1024
                ) -> List[torch.Tensor]:
    """Apply ``fn`` (e.g. an allreduce) to the fusion buckets of
    ``leaves`` and restore them: fuse, collective, unfuse."""
    plan = plan_fusion(leaves, threshold_bytes)
    return unfuse([fn(f) for f in fuse(leaves, plan)], plan)


def pad_to_multiple(flat: torch.Tensor, multiple: int):
    """Pad a flat buffer with zeros to a multiple of ``multiple``.
    Returns ``(padded, n)``."""
    n = flat.shape[0]
    rem = (-n) % multiple
    if rem:
        flat = torch.cat([flat, flat.new_zeros((rem,))])
    return flat, n
