"""Expert parallelism — GShard top-2 gated MoE with all-to-all dispatch;
the port of ``horovod_tpu/parallel/moe.py``.

Top-2 gating with a static capacity (overflow routes are dropped and the
surviving pair weights renormalized), dispatch of the token rows to the
ranks holding each expert, the expert FFN on each rank's local experts,
the inverse exchange back to the token owners, and the weighted combine.

The JAX package builds dense ``(T, E, C)`` dispatch and combine one-hots
and contracts them with einsums. The port computes the same function by
indexing: each kept route writes its token row into its ``(expert,
slot)`` of the ``(E, C, D)`` slabs, and each token's output is its two
routes' slab rows times their weights. Each slot holds at most one
token, so the slabs are exact; the combine is the same two products and
one sum. This is plain torch (the JAX module has no Pallas kernel).

The exchange is the wired all-to-all family of ``ops/collectives.py``:

* ``wire`` on the flat ``axis_name``: ``"none"``, ``"bf16"``, ``"int8"``
  (block-scaled codes by K2, K3 with a ``key``, dequantized by K4, a
  straight-through gradient) or ``"auto"`` (``fusion.
  assign_alltoall_wire`` on the slab's bytes);
* ``route=`` a ``WirePlan``: ``collectives.mesh_alltoall`` over the
  plan's axes, each hop in its axis's wire (the ep world is the product
  of the plan's axes, slow-axis-major);
* ``overlap_chunks=k`` splits the capacity into k chunks, each exchanged
  and run through the experts in turn (a pure reshape: the values are
  the unchunked ones, bitwise; ``expert_fn`` must be token-wise).

``wire``, ``overlap_chunks`` and ``capacity_factor`` left None take the
configured defaults (``init()``'s ``Config`` or ``HVD_TPU_MOE_WIRE``,
``_OVERLAP_CHUNKS``, ``_CAPACITY_FACTOR``; "none", 1 and 1.25 unset).

``return_stats=True`` adds the dropped routes, the dropped fraction and
the demanded load per expert, summed over the ep world (one allreduce
of E + 2 floats a call; ``MoeMlp`` keeps the local vector and reduces it
only when ``GPT.moe_stats()`` asks); :func:`record_moe_stats` publishes
them as the
``hvd_tpu_moe_{dropped_tokens,dropped_frac,expert_load}`` gauges.
Router noise draws from an explicit ``torch.Generator`` (the draws
differ from ``jax.random``'s).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..common import metrics as metrics_lib
from ..ops import collectives as C

_METRICS_ON = metrics_lib.enabled()
_M_DROPPED = metrics_lib.gauge(
    "hvd_tpu_moe_dropped_tokens",
    "token-routes dropped by capacity overflow in the most recently "
    "recorded MoE step (global count across the ep world; set by "
    "record_moe_stats from a moe_layer return_stats=True dict)")
_M_DROP_FRAC = metrics_lib.gauge(
    "hvd_tpu_moe_dropped_frac",
    "dropped token-routes as a fraction of all top-2 routes in the most "
    "recently recorded MoE step (the capacity-factor health number; "
    "docs/moe.md runbook)")
_M_LOAD = metrics_lib.gauge(
    "hvd_tpu_moe_expert_load",
    "demanded token-routes per expert (top-2 assignments INCLUDING "
    "dropped ones — the skew signal) in the most recently recorded MoE "
    "step", labels=("expert",))


class _Routes:
    """Top-2 routing of T tokens in index form: per choice the expert,
    the slot in its queue, whether it fits the capacity and the
    renormalized gate weight (0 for a dropped route)."""

    def __init__(self, e1, pos1, keep1, g1, e2, pos2, keep2, g2, aux,
                 demand):
        self.choices = ((e1, pos1, keep1, g1), (e2, pos2, keep2, g2))
        self.aux, self.demand = aux, demand


def _top2_routes(logits: torch.Tensor, capacity: int) -> _Routes:
    """The JAX ``_top2_gating_with_demand`` step for step, in index form:
    fp32 softmax; the first choice by argmax (ties to the first index,
    as ``torch.argmax`` and ``jnp.argmax`` both break them); the second
    by argmax with the first masked out; each choice's slot its running
    count in its expert, the second queued behind ALL first choices;
    routes at or past the capacity dropped; the surviving pair weights
    renormalized with a 1e-9 floor; the GShard auxiliary loss
    ``sum(mean probs x first-choice fraction) x E``; the demanded load
    counts both choices before the cut."""
    e = logits.shape[1]
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    e1 = torch.argmax(probs, dim=-1)
    g1 = probs.gather(-1, e1[:, None])[:, 0]
    oh1 = F.one_hot(e1, e)
    probs_wo1 = probs * (1.0 - oh1.to(torch.float32))
    e2 = torch.argmax(probs_wo1, dim=-1)
    g2 = probs_wo1.gather(-1, e2[:, None])[:, 0]
    me = probs.mean(dim=0)
    ce = oh1.to(torch.float32).mean(dim=0)
    aux = (me * ce).sum() * e
    oh2 = F.one_hot(e2, e)
    pos1 = (torch.cumsum(oh1, dim=0) - 1).gather(-1, e1[:, None])[:, 0]
    count1 = oh1.sum(dim=0)
    pos2 = (torch.cumsum(oh2, dim=0) - 1).gather(-1, e2[:, None])[:, 0] \
        + count1[e2]
    keep1 = pos1 < capacity
    keep2 = pos2 < capacity
    g1 = g1 * keep1
    g2 = g2 * keep2
    denom = torch.clamp_min(g1 + g2, 1e-9)
    g1, g2 = g1 / denom, g2 / denom
    demand = (oh1 + oh2).sum(dim=0).to(torch.float32)
    return _Routes(e1, pos1, keep1, g1, e2, pos2, keep2, g2, aux, demand)


def _top2_gating_with_demand(logits: torch.Tensor, capacity: int):
    """:func:`top2_gating` plus the per-expert DEMANDED route counts (both
    choices before the capacity cut): ``(dispatch, combine, aux,
    demand)`` in the JAX package's dense ``(T, E, C)`` layout."""
    t, e = logits.shape
    r = _top2_routes(logits, capacity)
    dispatch = torch.zeros((t, e, capacity), dtype=torch.float32,
                           device=logits.device)
    combine = torch.zeros_like(dispatch)
    rows = torch.arange(t, device=logits.device)
    for ex, pos, keep, g in r.choices:
        slot = torch.where(keep, pos, torch.zeros_like(pos))
        hit = keep.to(torch.float32)
        dispatch = dispatch.index_put((rows, ex, slot), hit,
                                      accumulate=True)
        combine = combine.index_put((rows, ex, slot), g * hit,
                                    accumulate=True)
    return dispatch.clamp(0.0, 1.0), combine, r.aux, r.demand


def top2_gating(logits: torch.Tensor, capacity: int,
                noise: Optional[torch.Tensor] = None):
    """GShard top-2 gating of ``logits`` (T, E); ``noise`` (same shape) is
    added first (noisy gating). Returns ``(dispatch (T, E, C),
    combine (T, E, C), aux_loss)``."""
    if noise is not None:
        logits = logits + noise
    return _top2_gating_with_demand(logits, capacity)[:3]


def _resolve_plan(route):
    return None if route is None else C.WirePlan.resolve(route)


def ep_size(axis_name="ep", route=None) -> int:
    """The expert-parallel world: the product of the route plan's axis
    sizes with ``route``, else the size of ``axis_name`` (1 with
    neither: the local MoE)."""
    plan = _resolve_plan(route)
    if plan is not None:
        return math.prod(C._axis(p.axis).size for p in plan.phases)
    return 1 if axis_name is None else C._axis(axis_name).size


def ep_index(axis_name="ep", route=None) -> int:
    """This rank's expert-parallel index, slow-axis-major under a route
    plan (``collectives.mesh_alltoall``'s global order): the index an
    ``expert_fn`` finds its global expert ids from."""
    plan = _resolve_plan(route)
    if plan is not None:
        idx = 0
        for p in reversed(plan.phases):        # slow axis first
            ax = C._axis(p.axis)
            idx = idx * ax.size + ax.index
        return idx
    return 0 if axis_name is None else C._axis(axis_name).index


def _capacity_bounds(capacity: int, chunks: int):
    """Static contiguous split of the capacity into ``chunks`` segments
    (the last may be shorter)."""
    chunks = max(1, min(int(chunks), capacity))
    step = -(-capacity // chunks)
    return [(lo, min(lo + step, capacity))
            for lo in range(0, capacity, step)]


def _resolve_wire(wire: str, slab_bytes: int,
                  quantize_min_bytes: Optional[int]) -> str:
    """``"auto"`` -> int8 at or above the threshold (``quantize_min_bytes``,
    else the configured ``quantize_min_bucket_bytes``, else the module
    default), bf16 below; any other wire as given."""
    if wire != "auto":
        return wire
    from ..common import basics
    from ..common import fusion as fusion_lib

    qmin = quantize_min_bytes
    if qmin is None and basics.is_initialized():
        qmin = basics.context().config.quantize_min_bucket_bytes
    if qmin is None:
        qmin = fusion_lib.A2A_QUANTIZE_MIN_BYTES
    return fusion_lib.assign_alltoall_wire(slab_bytes, qmin)


def moe_defaults(wire: Optional[str] = None,
                 overlap_chunks: Optional[int] = None,
                 capacity_factor: Optional[float] = None):
    """``(wire, overlap_chunks, capacity_factor)`` with each None replaced
    by its configured default: ``init()``'s ``Config`` when the world is
    up, else ``HVD_TPU_MOE_WIRE`` / ``_OVERLAP_CHUNKS`` /
    ``_CAPACITY_FACTOR``, else "none", 1 and 1.25. An explicit value
    wins."""
    if None not in (wire, overlap_chunks, capacity_factor):
        return wire, overlap_chunks, capacity_factor
    from ..common import basics
    from ..common import config as config_lib

    if basics.is_initialized():
        cfg = basics.context().config
        dw, dk, dc = (cfg.moe_wire, cfg.moe_overlap_chunks,
                      cfg.moe_capacity_factor)
    else:
        base = config_lib.Config
        dw = config_lib.runtime_env("MOE_WIRE")
        dk = config_lib.env_int("MOE_OVERLAP_CHUNKS",
                                base.moe_overlap_chunks)
        dc = config_lib.env_float("MOE_CAPACITY_FACTOR",
                                  base.moe_capacity_factor)
    return (wire if wire is not None else (dw or "none"),
            overlap_chunks if overlap_chunks is not None else dk,
            capacity_factor if capacity_factor is not None else dc)


def moe_layer(x: torch.Tensor, gate_w: torch.Tensor, expert_fn: Callable,
              num_experts: int, capacity_factor: Optional[float] = None,
              axis_name="ep", route=None, wire: Optional[str] = None,
              overlap_chunks: Optional[int] = None, key=None,
              return_stats: bool = False, router_noise_std: float = 0.0,
              quantize_min_bytes: Optional[int] = None,
              generator: Optional[torch.Generator] = None):
    """One MoE layer with the experts spread over the expert-parallel
    world.

    ``x`` (T, D) this rank's tokens; ``gate_w`` (D, E) the router;
    ``expert_fn(local_idx, rows (R, D)) -> (R, D)`` applied to each of
    this rank's ``E / n`` local experts (called once a capacity chunk
    with ``overlap_chunks > 1``, so it must be token-wise).
    ``axis_name`` the flat ep axis (None, with no ``route``: the local,
    exchange-free layer); ``route`` a WirePlan whose wires win over
    ``wire``; ``wire`` the flat axis's payload format (module
    docstring); ``key`` an int tuple that makes int8 roundings
    stochastic (folded per chunk and exchange); ``router_noise_std``
    adds ``std x N(0, 1)`` drawn from ``generator`` to the router logits
    (needs both). The capacity is ``int(capacity_factor * T * 2 / E) or
    1``; ``wire``, ``overlap_chunks`` and ``capacity_factor`` left None
    take :func:`moe_defaults`. Returns ``(y, aux_loss)`` or ``(y,
    aux_loss, stats)``."""
    y, aux, local = _moe_layer(
        x, gate_w, expert_fn, num_experts, capacity_factor, axis_name,
        route, wire, overlap_chunks, key, router_noise_std,
        quantize_min_bytes, generator, return_stats)
    if not return_stats:
        return y, aux
    return y, aux, reduce_moe_stats(local)


def _moe_layer(x, gate_w, expert_fn, num_experts, capacity_factor,
               axis_name, route, wire, overlap_chunks, key,
               router_noise_std, quantize_min_bytes, generator,
               local_stats: bool):
    """:func:`moe_layer`'s body: ``(y, aux, local)``, where ``local`` is
    this rank's stats vector and the axes that sum it (None unless
    ``local_stats``), for :func:`reduce_moe_stats`."""
    wire, overlap_chunks, capacity_factor = moe_defaults(
        wire, overlap_chunks, capacity_factor)
    plan = _resolve_plan(route)
    ax = None
    if plan is not None:
        n = ep_size(route=plan)
        psum_axes = list(plan.axis_names)
    elif axis_name is not None:
        ax = C._axis(axis_name)
        n = ax.size
        psum_axes = [ax] if n > 1 else []
    else:
        n, psum_axes = 1, []
    if num_experts % n:
        raise ValueError(f"{num_experts} experts not divisible by ep={n}")
    e_local = num_experts // n
    t, d = x.shape
    capacity = int(capacity_factor * t * 2 / num_experts) or 1
    wire = _resolve_wire(wire, num_experts * capacity * d
                         * x.element_size(), quantize_min_bytes)

    logits = x.to(torch.float32) @ gate_w.to(torch.float32)
    if router_noise_std > 0.0 and generator is not None:
        logits = logits + router_noise_std * torch.randn(
            logits.shape, generator=generator, dtype=torch.float32,
            device=logits.device)
    r = _top2_routes(logits, capacity)

    # The (E, C, D) slabs: each kept route's token row in its slot; a
    # dropped route writes a spare row past the end, cut off after (no
    # data-dependent shape, so no host synchronization).
    spare = num_experts * capacity
    flat_slots = torch.cat([torch.where(keep, ex * capacity + pos,
                                        torch.full_like(pos, spare))
                            for ex, pos, keep, _ in r.choices])
    slabs = x.new_zeros((spare + 1, d)).index_put(
        (flat_slots,), torch.cat([x, x]))[:spare]
    slabs = slabs.reshape(n, e_local, capacity, d)

    def exchange(buf, fold):
        kk = None if key is None else C.fold_in(key, fold)
        if plan is not None:
            return C.mesh_alltoall(buf, plan, key=kk)
        if n == 1:
            return buf
        C._count_a2a_bytes(ax.name, wire, buf.numel(), n,
                           buf.element_size())
        return C._a2a_exchange(buf.reshape(n, -1), ax, wire,
                               kk).reshape(buf.shape)

    backs = []
    for ci, (lo, hi) in enumerate(_capacity_bounds(capacity,
                                                   overlap_chunks)):
        ck = hi - lo
        routed = exchange(slabs[:, :, lo:hi].reshape(n * e_local * ck, d),
                          ci)
        # (n, e_l, ck, D) source-major -> each local expert's rows.
        rr = routed.reshape(n, e_local, ck, d).transpose(0, 1).reshape(
            e_local, n * ck, d)
        eo = torch.stack([expert_fn(le, rr[le]) for le in range(e_local)])
        b = eo.reshape(e_local, n, ck, d).transpose(0, 1).reshape(
            n * e_local * ck, d)
        backs.append(exchange(b, 100 + ci).reshape(n, e_local, ck, d))
    back = torch.cat(backs, dim=2) if len(backs) > 1 else backs[0]
    back = back.reshape(num_experts * capacity, d).to(torch.float32)

    y = None
    for ex, pos, keep, g in r.choices:
        slot = ex * capacity + torch.where(keep, pos,
                                           torch.zeros_like(pos))
        term = back[slot] * g[:, None]
        y = term if y is None else y + term
    y = y.to(x.dtype)
    if not local_stats:
        return y, r.aux, None
    with torch.no_grad():
        kept = sum(keep.sum() for _, _, keep, _ in r.choices)
        vec = torch.cat([r.demand, kept.reshape(1).to(torch.float32),
                         torch.full((1,), 2.0 * t, dtype=torch.float32,
                                    device=x.device)])
    return y, r.aux, (vec, psum_axes)


def reduce_moe_stats(local) -> dict:
    """A ``_moe_layer`` local stats vector summed over its ep axes (every
    rank of them calls this together) as the ``return_stats`` dict:
    ``dropped_tokens``, ``dropped_frac``, ``expert_load`` (demanded
    routes per expert) and ``routed_tokens``."""
    vec, psum_axes = local
    with torch.no_grad():
        for a in psum_axes:
            vec = C.allreduce(vec, C.Sum, axis=a)
        demanded, kept, routes = vec[:-2], vec[-2], vec[-1]
        dropped = torch.clamp_min(routes - kept, 0.0)
        return {"dropped_tokens": dropped,
                "dropped_frac": dropped / torch.clamp_min(routes, 1.0),
                "expert_load": demanded, "routed_tokens": routes}


def record_moe_stats(stats) -> dict:
    """Publish a ``moe_layer(return_stats=True)`` stats dict (host side,
    once per observed step): the ``hvd_tpu_moe_dropped_tokens`` and
    ``hvd_tpu_moe_dropped_frac`` gauges and one
    ``hvd_tpu_moe_expert_load{expert=}`` gauge per expert. Returns the
    plain-float dict."""
    def host(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)

    load = host(stats["expert_load"]).astype(np.float64).reshape(-1)
    out = {"dropped_tokens": float(host(stats["dropped_tokens"])),
           "dropped_frac": float(host(stats["dropped_frac"])),
           "expert_load": [float(v) for v in load]}
    if _METRICS_ON:
        _M_DROPPED.set(out["dropped_tokens"])
        _M_DROP_FRAC.set(out["dropped_frac"])
        for e, v in enumerate(load):
            _M_LOAD.labels(expert=str(e)).set(float(v))
    return out


def chaos_skew_gate(gate_w: torch.Tensor) -> torch.Tensor:
    """Chaos site ``moe_skew``: when the installed fault plan fires, the
    router weights biased toward one hot expert — ``spec.target`` names
    the expert column (default 0), ``spec.scale`` the boost (default 10)
    — as a new tensor, so the skewed logits run the real gating and
    capacity path. Host side, between steps; ``gate_w`` itself when
    nothing fires."""
    from ..common import faults as faults_lib

    spec = faults_lib.maybe_moe_skew()
    if spec is None:
        return gate_w
    target = int(spec.target or 0)
    scale = spec.scale if spec.scale else 10.0
    out = gate_w.detach().clone()
    out[..., target] += torch.tensor(scale, dtype=out.dtype)
    return out


__all__ = ["moe_layer", "moe_defaults", "top2_gating", "ep_size",
           "ep_index", "record_moe_stats", "chaos_skew_gate"]
