"""Overlap of the gradient reduction with the rest of the step (D2) — the
port's copy of ``horovod_tpu/common/overlap.py``.

The JAX package pins the issue order of its bucket collectives with an
``optimization_barrier`` chain and leaves the overlap to XLA's
latency-hiding scheduler. Eager PyTorch has no scheduler: the order is
pinned the way reference Horovod's background thread pins it. One
:class:`IssueWorker` a reducer runs every submitted reduction, one after
another, in submission order, on its own thread and (on the GPU) its own
CUDA stream: the caller's thread submits a bucket's whole hop chain as
soon as the bucket is ready and goes on with the backward (or the
forward) while the worker's collectives run. Every rank submits in the
same order, so the ranks issue their collectives in one order.

Values never change: a chain computes what it would compute on the
caller's thread (the same functions on the same inputs), so
``overlap=True`` is bitwise ``overlap=False``. The worker never swallows
an error: a failed chain's exception is raised by its :class:`Pending`'s
``wait()`` (the optimizer's ``synchronize()``), and every chain after it
fails at once without issuing a collective.

Streams: a submission records an event on the caller's current stream,
which the worker's stream waits on before the chain runs; ``wait()``
makes the caller's stream wait on the chain's end and marks the chain's
output tensors as used there (``record_stream``), so the caching
allocator does not hand their memory to the worker early.

Collectives of the caller's own: a collective that leaves this process
from any other thread while a worker holds submitted chains (a
SyncBatchNorm all-reduce under the backward, a metric's
``hvd.allreduce`` under a stage-3 prefetch) would interleave with the
chains in an order that can differ between ranks. Every collective of
``ops/collectives.py`` and the eager engine therefore calls
:func:`drain_before_collective` first, which waits until every live
worker has run what was submitted to it: the caller's collective is
issued after the same chains on every rank (those submitted before it,
in the same order), never among them. A worker whose owner abandoned
its step (an elastic reset, :meth:`IssueWorker.abandon`) leaves the
registry and fails what it still holds without issuing it.

Surfaces: :func:`chain_issue_order`, :func:`fused_apply_overlapped` and
:func:`staged_value_and_grad` (plain functions on tensors);
``DistributedOptimizer(overlap=True)`` (``optim.py``) and
``ZeroOptimizer(overlap=True)`` (``zero.py``) own one worker each.
"""

from __future__ import annotations

import queue
import threading
import time
import weakref
from typing import Any, Callable, List, Optional, Sequence, Union

import torch

from . import fusion as fusion_lib
from . import tree as tree_lib


class Pending:
    """The result of one submitted chain."""

    def __init__(self):
        self._done = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._event = None
        self._device = None

    def _set(self, value=None, error=None, event=None,
             device=None) -> None:
        self._value, self._error = value, error
        self._event, self._device = event, device
        self._done.set()

    def wait(self) -> Any:
        """Block until the chain ran; raise its error, or make the
        current stream wait on it and return its value."""
        self._done.wait()
        if self._error is not None:
            raise self._error
        if self._event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(self._event)
            for t in tree_lib.tensors(self._value):
                if t.is_cuda:
                    t.record_stream(stream)
        return self._value


# The live workers (see "Collectives of the caller's own" above), and a
# flag each worker thread sets on itself.
_live: "weakref.WeakSet[IssueWorker]" = weakref.WeakSet()
_local = threading.local()


def drain_before_collective() -> None:
    """Before a collective issued by a thread that is no worker's: wait
    until every live worker has run every chain submitted to it."""
    if getattr(_local, "is_worker", False):
        return
    for w in list(_live):
        w.drain()


def _abandoned_error() -> RuntimeError:
    return RuntimeError("the overlapped reduction's step was abandoned")


class IssueWorker:
    """One background thread (and, on the GPU, one CUDA stream) that runs
    submitted chains in submission order. ``device`` None or a CPU
    device: no stream."""

    def __init__(self, device: Optional[Union[str, torch.device]] = None,
                 name: str = "hvd-overlap"):
        dev = torch.device(device) if device is not None else None
        self.device = dev
        self._stream = torch.cuda.Stream(dev) \
            if dev is not None and dev.type == "cuda" else None
        self._jobs: "queue.Queue" = queue.Queue()
        self._failed: Optional[BaseException] = None
        self._abandoned = False
        #: Chains submitted and not yet run, under its condition.
        self._outstanding = 0
        self._idle = threading.Condition()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._thread.start()
        _live.add(self)
        #: Chains run so far, and the host seconds the thread spent in
        #: them.
        self.chains = 0
        self.busy_s = 0.0

    def submit(self, fn: Callable, *args) -> Pending:
        """Run ``fn(*args)`` after every chain submitted before it."""
        if self._abandoned:
            pending = Pending()
            pending._set(error=_abandoned_error())
            return pending
        ready = None
        if self._stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            for t in tree_lib.tensors(list(args)):
                if t.is_cuda:
                    t.record_stream(self._stream)
        pending = Pending()
        with self._idle:
            self._outstanding += 1
        self._jobs.put((fn, args, ready, pending))
        return pending

    def drain(self) -> None:
        """Block until every chain submitted so far has run."""
        with self._idle:
            self._idle.wait_for(lambda: self._outstanding == 0)

    def abandon(self) -> None:
        """Give the worker up (its owner's step was abandoned): it leaves
        the registry, fails every chain it still holds without running
        it, and stops. The chain it may be running (a collective of a
        torn-down world) ends when that world's collective does."""
        self._abandoned = True
        _live.discard(self)
        self._jobs.put(None)

    def _run(self) -> None:
        _local.is_worker = True
        while True:
            job = self._jobs.get()
            if job is None:
                return
            self._run_one(*job)
            # Hold nothing of a finished chain: its function (a bound
            # method of its owner) would keep the owner alive.
            del job
            with self._idle:
                self._outstanding -= 1
                self._idle.notify_all()

    def _run_one(self, fn, args, ready, pending) -> None:
        if self._abandoned:
            pending._set(error=_abandoned_error())
            return
        if self._failed is not None:
            # Issue nothing after a failed chain: its peers may be gone,
            # and a later collective would only hang.
            pending._set(error=RuntimeError(
                f"an earlier overlapped reduction failed "
                f"({type(self._failed).__name__}: {self._failed})"))
            return
        t0 = time.perf_counter()
        try:
            if self._stream is None:
                pending._set(value=fn(*args))
            else:
                with torch.cuda.stream(self._stream):
                    self._stream.wait_event(ready)
                    value = fn(*args)
                    done = torch.cuda.Event()
                    done.record(self._stream)
                pending._set(value=value, event=done, device=self.device)
            self.chains += 1
        except BaseException as e:  # noqa: BLE001 — re-raised by wait()
            self._failed = e
            pending._set(error=e)
        self.busy_s += time.perf_counter() - t0

    def close(self) -> None:
        """Stop the thread after the chains already submitted."""
        if self._thread.is_alive():
            self._jobs.put(None)
            self._thread.join()
        _live.discard(self)

    def close_with(self, owner) -> None:
        """Stop the thread once ``owner`` is garbage collected."""
        weakref.finalize(owner, self._jobs.put, None)


def chain_issue_order(flats: Sequence[torch.Tensor], fn: Callable,
                      worker: Optional[IssueWorker] = None
                      ) -> List[Any]:
    """``[fn(f) for f in flats]`` with the issue order pinned: each call
    runs on ``worker`` (a private one when None) after the one before
    it. Returns the outputs once every call finished (the values are
    those of the plain list comprehension)."""
    own = worker is None
    if own:
        dev = next((f.device for f in flats
                    if isinstance(f, torch.Tensor)), None)
        worker = IssueWorker(dev)
    try:
        pend = [worker.submit(fn, f) for f in flats]
        return [p.wait() for p in pend]
    finally:
        if own:
            worker.close()


def fused_apply_overlapped(leaves: Sequence[torch.Tensor], fn: Callable,
                           threshold_bytes: int,
                           order: Union[str, Sequence[int]] =
                           fusion_lib.ORDER_REVERSE,
                           worker: Optional[IssueWorker] = None
                           ) -> List[torch.Tensor]:
    """``fusion.fused_apply`` with readiness-ordered buckets (reverse
    flatten order by default) and :func:`chain_issue_order`: plan, fuse,
    ``fn`` a bucket in order, unfuse back into the leaves' order."""
    plan = fusion_lib.plan_fusion(leaves, threshold_bytes, order=order)
    outs = chain_issue_order(fusion_lib.fuse(leaves, plan), fn, worker)
    return fusion_lib.unfuse(outs, plan)


def _grad_leaves(tree):
    """``tree`` with each tensor leaf a detached copy that requires
    grad, and those leaves in order."""
    mapped = tree_lib.map_tree(
        lambda t: t.detach().requires_grad_(True)
        if isinstance(t, torch.Tensor) else t, tree)
    return mapped, tree_lib.tensors(mapped)


def staged_value_and_grad(stage_fns: Sequence[Callable],
                          loss_fn: Callable,
                          params: Sequence[Any],
                          x,
                          reduce_fn: Optional[Callable] = None,
                          worker: Optional[IssueWorker] = None):
    """Per-stage backward with each stage's gradient reduction issued as
    soon as its gradients exist. ``stage_fns[i](params[i], act) -> act``
    chain into ``loss_fn(act) -> scalar``. The backward walks the stages
    from the last; stage ``i``'s ``reduce_fn(grad_tree)`` is submitted to
    ``worker`` (a private one when None) and runs while stage ``i - 1``
    differentiates, the reductions in backward order. Returns ``(loss,
    grads)``, ``grads[i]`` the (reduced) gradient tree of ``params[i]``
    (zeros for a leaf the loss does not reach). With ``reduce_fn=None``
    it is a staged ``value_and_grad``."""
    if len(stage_fns) != len(params):
        raise ValueError(f"{len(stage_fns)} stage fns but {len(params)} "
                         f"param trees")
    stages = []
    act = x
    for f, p in zip(stage_fns, params):
        p_tree, p_leaves = _grad_leaves(p)
        inp = act.detach().requires_grad_(True) \
            if isinstance(act, torch.Tensor) and act.is_floating_point() \
            else act
        out = f(p_tree, inp)
        stages.append((p_tree, p_leaves, inp, out))
        act = out
    last = act.detach().requires_grad_(True)
    loss = loss_fn(last)
    (g_act,) = torch.autograd.grad(loss, [last])
    own = reduce_fn is not None and worker is None
    if own:
        worker = IssueWorker(g_act.device)
    try:
        grads: List[Any] = [None] * len(stage_fns)
        for i in range(len(stage_fns) - 1, -1, -1):
            p_tree, p_leaves, inp, out = stages[i]
            wrt = list(p_leaves) + ([inp] if isinstance(inp, torch.Tensor)
                                    and inp.requires_grad else [])
            got = torch.autograd.grad(out, wrt, grad_outputs=g_act,
                                      allow_unused=True)
            got = [torch.zeros_like(w) if g is None else g
                   for g, w in zip(got, wrt)]
            g_leaves = got[:len(p_leaves)]
            g_act = got[len(p_leaves)] if len(wrt) > len(p_leaves) \
                else None
            it = iter(g_leaves)
            g_tree = tree_lib.map_tree(
                lambda t: next(it) if isinstance(t, torch.Tensor) else t,
                p_tree)
            grads[i] = g_tree if reduce_fn is None \
                else worker.submit(reduce_fn, g_tree)
        if reduce_fn is not None:
            grads = [g.wait() for g in grads]
    finally:
        if own:
            worker.close()
    return loss.detach(), grads
