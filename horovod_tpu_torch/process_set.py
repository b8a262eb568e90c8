"""Process sets — named subset communicators, the port of
``horovod_tpu/process_set.py``.

A registered :class:`ProcessSet` holds a ``torch.distributed`` subgroup
over its member ranks (an :class:`~.common.topology.Axis`) and its own
eager engine over that axis, with no controller: collectives within a
set skip the cross-rank negotiation, as in the JAX package, and keeping
the members in one program order is the caller's part. Every eager call
and ``DistributedOptimizer`` takes ``process_set=``::

    evens = hvd.add_process_set(hvd.ProcessSet([0, 2]))
    out = hvd.allreduce(x, process_set=evens)   # over ranks 0 and 2

Registration is collective over the whole world, as Horovod's is: every
rank calls ``add_process_set`` with the same ranks, in the same order,
members or not (``torch.distributed.new_group`` must be entered by every
rank). The ranks are first compared through the controller's store: a
rank that registers other ranks makes every rank raise ``ValueError``,
and a rank that does not register makes the others raise
``HorovodInternalError`` after the controller's timeout, before any
group is made. A non-member's set-scoped call raises ``ValueError``
before any collective.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence, Tuple

import torch.distributed as dist


class ProcessSet:
    """An ordered, de-duplicated set of global ranks. Inert until
    registered through :func:`add_process_set` (or ``init(process_sets=)``),
    which attaches its axis and engine."""

    def __init__(self, ranks: Sequence[int]):
        rs: Tuple[int, ...] = tuple(sorted({int(r) for r in ranks}))
        if not rs:
            raise ValueError("a ProcessSet needs at least one rank")
        self.ranks = rs
        self._engine = None
        self.axis = None

    @property
    def engine(self):
        """The set's engine; raises ``ValueError`` when the set is not
        registered or this rank is not a member."""
        if self.axis is None:
            raise ValueError(
                f"{self!r} is not registered; call hvd.add_process_set "
                "(after hvd.init) first")
        if self._engine is None:
            from .common import basics

            raise ValueError(
                f"rank {basics.rank()} is not a member of {self!r}; only "
                "member ranks may call a set-scoped collective")
        return self._engine

    def size(self) -> int:
        return len(self.ranks)

    def rank(self) -> int:
        """This process's position in the set, or -1 when it is not a
        member."""
        from .common import basics

        me = basics.rank()
        return self.ranks.index(me) if me in self.ranks else -1

    def included(self) -> bool:
        return self.rank() >= 0

    def __repr__(self) -> str:
        state = "registered" if self.axis is not None else "unregistered"
        return f"ProcessSet(ranks={list(self.ranks)}, {state})"


def member_engine(process_set: Optional[ProcessSet] = None):
    """The engine a call with ``process_set=`` runs on: the world's for
    None, else the set's, raising ``ValueError`` for an unregistered set
    and for a process outside it."""
    from .common import basics

    if process_set is None:
        return basics.context().engine
    if not isinstance(process_set, ProcessSet):
        raise TypeError(f"process_set must be a ProcessSet or None, got "
                        f"{process_set!r}")
    return process_set.engine


def add_process_set(process_set) -> ProcessSet:
    """Register a :class:`ProcessSet` (or a list of ranks) on every rank
    of the world: its subgroup and its engine. Collective: see the
    module's docstring."""
    from .common import basics
    from .common.topology import Axis
    from .ops.eager import EagerEngine

    ctx = basics.context()
    if not isinstance(process_set, ProcessSet):
        process_set = ProcessSet(process_set)
    bad = [r for r in process_set.ranks if not 0 <= r < ctx.size]
    if bad:
        raise ValueError(f"process set ranks {bad} outside world size "
                         f"{ctx.size}")
    seq = ctx.process_set_seq
    ctx.process_set_seq += 1
    if ctx.controller is not None:
        diff = ctx.controller.agree(f"process_set.{seq}",
                                    json.dumps(list(process_set.ranks)))
        if diff:
            raise ValueError(
                f"add_process_set: ranks {diff} registered other ranks "
                f"than {list(process_set.ranks)} as process set #{seq}; "
                "every rank registers the same sets in the same order")
    ranks = process_set.ranks
    group = dist.new_group(list(ranks)) if ctx.size > 1 else None
    me = ranks.index(ctx.rank) if ctx.rank in ranks else -1
    process_set.axis = Axis("ps:" + ",".join(str(r) for r in ranks), group,
                            len(ranks), me, ranks)
    if me >= 0:
        process_set._engine = EagerEngine(
            ctx.config, ctx.device, me, len(ranks), controller=None,
            timeline=ctx.timeline, stall_inspector=ctx.stall,
            axis=process_set.axis,
            ps_tag=process_set.axis.name)
    ctx.process_sets.append(process_set)
    return process_set


def remove_process_set(process_set) -> None:
    """Unregister a set, given as the registered instance, an equal
    instance or its rank list; its engine goes (the subgroup lives until
    ``shutdown()``)."""
    from .common import basics

    ctx = basics.context()
    if isinstance(process_set, ProcessSet) and \
            process_set in ctx.process_sets:
        resolved = process_set
    else:
        ranks = tuple(sorted({int(r) for r in (
            process_set.ranks if isinstance(process_set, ProcessSet)
            else process_set)}))
        matches = [ps for ps in ctx.process_sets if ps.ranks == ranks]
        if not matches:
            raise ValueError(f"no registered process set with ranks "
                             f"{list(ranks)}")
        resolved = matches[0]
    for ps in (resolved, process_set):
        if isinstance(ps, ProcessSet):
            ps._engine, ps.axis = None, None
    ctx.process_sets = [ps for ps in ctx.process_sets if ps is not resolved]
