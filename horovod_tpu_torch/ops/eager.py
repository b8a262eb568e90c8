"""Eager collective engine — the port of ``horovod_tpu/ops/eager.py``, the
runtime behind Horovod's own API: named asynchronous collectives with
handles, negotiation, join and the exchanges.

The port holds the JAX package's multi-process convention, one rank per
process: each process passes its local tensor and gets its local result
(there are no rank-major stacked arrays, no ``scatter``/``gather``). A
collective goes through

* ``_begin``: the full name ``<kind>.<name>`` (unnamed tensors are
  numbered), a wait while the same name is still in flight
  (``DuplicateTensorNameError`` after ``duplicate_wait_seconds``), the
  timeline's begin event and the flight recorder;
* ``_negotiate``: the cross-rank check of the signature through the
  controller (``common/controller.py``); a signature in the engine's LRU
  (``config.cache_capacity``) or the controller's cache makes no store
  round, so a training loop negotiates each tensor once. Unnamed tensors
  are renamed to a digest of their signature first, so their repeats hit
  the cache too. In join mode every collective is a lockstep round
  instead (see ``join``);
* the issue: the prescale (``collectives._apply_scale``, kernel K1 on a
  CUDA tensor) and the ``torch.distributed`` calls with
  ``async_op=True``. The result is a :class:`_Pending` holding the works;
  ``synchronize`` waits for them and then runs, on the current stream,
  what follows the wire: the division of AVERAGE, the postscale (K1) and
  the decompression; ``_end`` then closes the name. There is no
  finalizer thread (the JAX engine's waits on device buffers): a
  collective's completion bookkeeping — the name, the timeline's end
  event, the flight recorder — runs when its result is synchronized, and
  ``shutdown()`` synchronizes what is left.

Compression of ``allreduce`` is none, fp16 or bf16 (a cast around the
reduction), or the ``int8_ef`` default of ``HVD_TPU_COMPRESSION``: a
float SUM/AVERAGE payload of at least ``quantize_min_bucket_bytes`` then
runs ``collectives.quantized_allreduce`` (round to nearest: an eager call
carries no error-feedback residual), a smaller fp32 one the bf16 cast.
``op=Adasum`` runs ``ops/adasum.py``. Both run to their end at issue.

Left out, each raising ``NotImplementedError`` naming its slice: the
hierarchical mesh (``hier_mesh``) and the chunked ``alltoallv`` with its
wire (slice 3b, mesh routing), process sets (``ps_tag``), the autotuner,
the stall inspector and fault injection.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..common import flightrec as flightrec_lib
from ..common import fusion as fusion_lib
from ..common import metrics as metrics_lib
from ..common.config import runtime_env
from ..common.controller import Request
from ..common.exceptions import (DuplicateTensorNameError,
                                 HorovodInternalError, MismatchError,
                                 TensorShapeMismatchError)
from ..native import ResponseCacheNative
from . import collectives as C
from .compression import (BF16Compressor, Compression, Int8Compressor,
                          NoneCompressor)

logger = logging.getLogger("horovod_tpu_torch")

# Telemetry: the JAX engine's families, by name. _METRICS_ON freezes the
# enable state at import so a disabled site is one bool check.
_METRICS_ON = metrics_lib.enabled()
_M_DISPATCH = metrics_lib.histogram(
    "hvd_tpu_dispatch_seconds",
    "host-side dispatch latency of eager collectives (submit to async "
    "dispatch return, per op kind)",
    labels=("op",))
_M_COMPLETE = metrics_lib.histogram(
    "hvd_tpu_collective_seconds",
    "submit-to-result latency of eager collectives (recorded when the "
    "result is synchronized, per op kind)",
    labels=("op",))
_M_CACHE = metrics_lib.counter(
    "hvd_tpu_eager_cache_total",
    "eager signature cache lookups by result",
    labels=("result",))
_M_CACHE_HIT = _M_CACHE.labels(result="hit")
_M_CACHE_MISS = _M_CACHE.labels(result="miss")
_M_BYTES = metrics_lib.counter(
    "hvd_tpu_collective_bytes_total",
    "per-process payload bytes per eager collective: raw (caller "
    "dtype) vs wire (what crosses the interconnect)",
    labels=("op", "kind"))
_M_AR_WIRE = metrics_lib.counter(
    "hvd_tpu_allreduce_bytes_total",
    "allreduce bytes on the wire by wire format and mesh axis "
    "(axis=flat: eager per-call accounting; int8 includes the "
    "per-4096-block fp32 scales)",
    labels=("wire", "axis"))
_M_A2A_WIRE = metrics_lib.counter(
    "hvd_tpu_alltoall_bytes_total",
    "alltoall bytes on the wire by wire format and mesh axis "
    "(axis=flat: eager per-call accounting; the self-chunk never "
    "crosses the wire and is excluded; int8 includes the per-4096-block "
    "fp32 scales)",
    labels=("wire", "axis"))


def _wire_bytes_int8(elems: int) -> int:
    """int8 wire cost: 1 byte per element + one fp32 scale per block."""
    return elems + 4 * ((elems + 4095) // 4096)


def _count_bytes(op: str, raw: int, wire: Optional[int] = None) -> None:
    if _METRICS_ON:
        _M_BYTES.labels(op=op, kind="raw").inc(raw)
        _M_BYTES.labels(op=op, kind="wire").inc(raw if wire is None
                                                else wire)


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the JAX package's (numpy's)
    dtype names, which the negotiation requests carry."""
    return str(dtype).replace("torch.", "")


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class _Pending:
    """One issued collective: its works in flight and the step that turns
    their buffers into the result. ``wait`` runs that step once, then
    closes the name in the engine."""

    __slots__ = ("_engine", "_full", "_works", "_finish", "_done",
                 "_result")

    def __init__(self, engine: "EagerEngine", full: Optional[str],
                 works: List, finish):
        self._engine = engine
        self._full = full
        self._works = works
        self._finish = finish
        self._done = False
        self._result = None

    def ready(self) -> bool:
        return self._done or all(w.is_completed() for w in self._works)

    def wait(self):
        if not self._done:
            try:
                self._result = C.wait_issued((self._works, self._finish))
            except Exception as e:
                self._done = True
                self._engine._fail(self._full, e)
                raise
            self._done = True
            self._engine._end(self._full)
        return self._result


class InPlace:
    """A pending collective whose result ``wait`` writes into ``target``
    and returns ``target`` — the handles of the ``*_async_`` calls."""

    __slots__ = ("_pending", "_target")

    def __init__(self, pending: _Pending, target: torch.Tensor):
        self._pending = pending
        self._target = target

    def ready(self) -> bool:
        return self._pending.ready()

    def wait(self) -> torch.Tensor:
        self._target.copy_(self._pending.wait())
        return self._target


class HandleManager:
    """int handle -> pending result (reference
    ``torch/handle_manager.cc``), the port of the JAX engine's.

    Retention is bounded: past ``max_retained`` entries, ``allocate``
    evicts the oldest COMPLETED results first (an evicted handle behaves
    like an already-synchronized one: ``poll`` -> True, ``synchronize``
    -> KeyError naming the eviction). A table full of in-flight work
    raises. ``HVD_TPU_MAX_RETAINED_HANDLES`` sets the bound."""

    max_retained = 16384
    _env = runtime_env("MAX_RETAINED_HANDLES", "")
    if _env:
        try:
            max_retained = int(_env)
        except ValueError:
            raise ValueError(
                f"HVD_TPU_MAX_RETAINED_HANDLES must be an integer >= 1, "
                f"got {_env!r}") from None
        if max_retained < 1:
            raise ValueError(
                f"HVD_TPU_MAX_RETAINED_HANDLES must be >= 1, got {_env}")
    del _env

    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0
        self._results: Dict[int, Any] = {}
        self._evicted_count = 0

    def allocate(self, value) -> int:
        evicted = []
        with self._lock:
            if len(self._results) >= self.max_retained:
                target = self.max_retained // 2
                for h in list(self._results):
                    if len(self._results) <= target:
                        break
                    if self._results[h].ready():
                        evicted.append(self._results.pop(h))
                self._evicted_count += len(evicted)
                if evicted and not getattr(self, "_evict_warned", False):
                    self._evict_warned = True
                    logger.warning(
                        "HandleManager evicted %d completed-but-never-"
                        "synchronized results (table hit max_retained="
                        "%d). synchronize() handles promptly — a "
                        "synchronize() on an evicted handle raises "
                        "KeyError.", len(evicted), self.max_retained)
                if len(self._results) >= self.max_retained:
                    raise RuntimeError(
                        f"{len(self._results)} unsynchronized in-flight "
                        f"handles (max_retained={self.max_retained}); "
                        "synchronize() results instead of only polling")
            h = self._next
            self._next += 1
            self._results[h] = value
        for val in evicted:     # close their names; the results are gone
            val.wait()
        return h

    def poll(self, handle: int) -> bool:
        """True when the result is ready; a handle already synchronized
        (or never issued) reports True."""
        with self._lock:
            val = self._results.get(handle)
        return True if val is None else val.ready()

    def synchronize(self, handle: int):
        with self._lock:
            if handle not in self._results:
                hint = ""
                if self._evicted_count:
                    hint = (f" (NOTE: this table has evicted "
                            f"{self._evicted_count} completed-but-"
                            f"unsynchronized results after hitting "
                            f"max_retained={self.max_retained}; if this "
                            f"handle was issued long ago it was likely "
                            f"evicted — raise "
                            f"HVD_TPU_MAX_RETAINED_HANDLES or "
                            f"synchronize() promptly)")
                raise KeyError(
                    f"unknown or already-synchronized handle: "
                    f"{handle}{hint}")
            val = self._results.pop(handle)
        return val.wait()

    def outstanding(self) -> List[int]:
        with self._lock:
            return list(self._results)


class EagerEngine:
    """The eager collectives of one process of the world."""

    # How long a re-submission of an in-flight name waits for its
    # predecessor before raising DuplicateTensorNameError.
    duplicate_wait_seconds = 30.0
    _JOIN_SENTINEL = "JOIN"

    def __init__(self, config, device: torch.device, rank: int, size: int,
                 controller=None, timeline=None, hier_mesh=None,
                 stall_inspector=None, autotuner=None, ps_tag: str = ""):
        for value, what, where in (
                (hier_mesh, "hier_mesh", "slice 3b (mesh routing)"),
                (stall_inspector, "stall_inspector", "the telemetry slice"),
                (autotuner, "autotuner", "the autotune slice"),
                (ps_tag, "ps_tag", "the process-set slice")):
            if value:
                raise NotImplementedError(
                    f"EagerEngine({what}=...) is not ported yet; it comes "
                    f"with {where} of the port")
        self.config = config
        self.device = device
        self.rank = rank
        self.size = size
        self.controller = controller
        self.timeline = timeline
        comp = Compression.by_name(config.compression)
        if not getattr(comp, "reduce_safe", True):
            raise ValueError(
                f"compression={config.compression} is a wire-format "
                "compressor (per-block scales don't commute with "
                "summation) and cannot be the default reduction "
                "compression; use fp16/bf16 (cast) or int8_ef "
                "(reduce-safe quantized allreduce)")
        self._default_compression = comp
        self._lru = ResponseCacheNative(config.cache_capacity)
        self.handles = HandleManager()
        self._inflight_names: set = set()
        self._names_lock = threading.Lock()
        self._noname_seq = 0
        self._submit_ts: Dict[str, float] = {}
        # Join protocol state: the lockstep round counter (the same on
        # every process, since every round gathers from all of them) and
        # rank 0's join order.
        self._join_seq = 0
        self._coord_joined: List[int] = []

    # -- named-tensor tracking -------------------------------------------

    def _begin(self, name: Optional[str], kind: str) -> str:
        if name is None:
            with self._names_lock:
                self._noname_seq += 1
                name = f"noname.{self._noname_seq}"
        full = f"{kind}.{name}"
        # Re-submitting a name whose previous result was not synchronized
        # yet waits briefly; only a stuck predecessor is an error.
        deadline = time.monotonic() + self.duplicate_wait_seconds
        while True:
            with self._names_lock:
                if full not in self._inflight_names:
                    idle = not self._inflight_names
                    self._inflight_names.add(full)
                    break
            if time.monotonic() > deadline:
                raise DuplicateTensorNameError(
                    f"tensor {full} re-submitted while a previous "
                    "submission was never synchronized")
            time.sleep(0.001)
        flightrec_lib.recorder().record_submit(full, kind)
        if _METRICS_ON:
            self._submit_ts[full] = time.perf_counter()
        if self.timeline is not None:
            if idle:
                self.timeline.mark_cycle()
            self.timeline.begin(full, kind.upper())
        return full

    def _end(self, full: Optional[str]) -> None:
        if full is None:
            return
        with self._names_lock:
            self._inflight_names.discard(full)
        if _METRICS_ON:
            t0 = self._submit_ts.pop(full, None)
            if t0 is not None:
                _M_COMPLETE.labels(op=full.split(".", 1)[0]).observe(
                    time.perf_counter() - t0)
        flightrec_lib.recorder().record_complete(full)
        if self.timeline is not None:
            self.timeline.end(full)

    def _fail(self, full: Optional[str], exc: BaseException) -> None:
        """A collective's error: stamp the outcome into the flight ring,
        then close the name."""
        if full is not None:
            flightrec_lib.recorder().record_complete(
                full, outcome=f"error:{type(exc).__name__}")
        self._end(full)

    def _pending(self, full: Optional[str], issued) -> _Pending:
        if _METRICS_ON and full is not None:
            t0 = self._submit_ts.get(full)
            if t0 is not None:
                _M_DISPATCH.labels(op=full.split(".", 1)[0]).observe(
                    time.perf_counter() - t0)
        return _Pending(self, full, *issued)

    # -- negotiation -----------------------------------------------------

    def _negotiate(self, op_type: str, name: str, x=None,
                   reduce_op: int = 0, root_rank: int = -1, shape=None,
                   dtype: Optional[str] = None,
                   wire: Optional[str] = None) -> None:
        """Check, before any dispatch, that every process submitted the
        same collective (shape, dtype, op, wire) under this name; a
        mismatch raises MismatchError naming the diverged ranks on every
        rank. A signature in the LRU, or in the controller's cache, makes
        no store round.

        Unnamed (``noname``) tensors are renamed to a digest of their
        signature: a per-call name would make every unnamed collective a
        fresh round; a divergence then shows as a missing rank rather
        than a field-level report."""
        if shape is None:
            shape = tuple(x.shape)
        if dtype is None:
            dtype = dtype_name(x.dtype)
        shape = tuple(int(d) for d in shape)
        if ".noname." in name:
            sig = repr((op_type, shape, dtype, reduce_op, root_rank, wire,
                        ""))
            name = (f"{op_type}.auto."
                    f"{hashlib.sha1(sig.encode()).hexdigest()[:16]}")
        req = Request(self.rank, op_type, name, dtype, shape, int(reduce_op),
                      int(root_rank), wire_dtype=wire or "")
        if self.join_active():
            self._join_round(req)
            return
        sig = req.signature()
        hit = self._lru.lookup(sig)
        if _METRICS_ON:
            (_M_CACHE_HIT if hit else _M_CACHE_MISS).inc()
        if hit:
            return
        if self.controller is not None:
            self.controller.negotiate(req)
        self._lru.put(sig)

    def _wire_contract(self, compression) -> str:
        """The wire tag of the cross-rank contract: the compressor's name
        (plus the quantize-min knob for a quantized reduction), "" for
        none — ranks configured differently get a MismatchError."""
        name = compression.__name__
        if name == "NoneCompressor":
            return ""
        if getattr(compression, "quantized_reduce", False):
            return f"{name}/qmin{self.config.quantize_min_bucket_bytes}"
        return name

    def cache_info(self) -> dict:
        return {"entries": len(self._lru),
                "capacity": self.config.cache_capacity}

    # -- join protocol ---------------------------------------------------
    #
    # In join mode every eager collective is a lockstep round over the
    # store: each process submits its collective's Request or the JOIN
    # sentinel; rank 0 validates and publishes the round's outcome. A
    # joined process loops rounds from inside join(), answering JOIN and
    # re-dispatching the active processes' allreduces with zero tensors
    # of the announced shape and dtype, until every process has joined.

    def join_active(self) -> bool:
        return (self.config.join_mode and self.controller is not None
                and self.controller.size > 1)

    def _join_wait(self, key: str, patient: bool, what: str
                   ) -> Optional[str]:
        """Read ``key``: within the controller timeout for an active
        process (None past it); a joined process waits for its peers,
        who may compute for long between collectives, up to
        ``config.stall_shutdown_time_seconds`` (0 = forever), then raises
        naming what it waited for."""
        c = self.controller
        if not patient:
            return c.transport.get(key, c.timeout_s)
        limit = self.config.stall_shutdown_time_seconds
        start = time.monotonic()
        while True:
            left = limit - (time.monotonic() - start)
            raw = c.transport.get(
                key, c.timeout_s if limit <= 0 else
                max(0.0, min(c.timeout_s, left)))
            if raw is not None:
                return raw
            if limit > 0 and time.monotonic() - start >= limit:
                raise HorovodInternalError(
                    f"joined rank {c.rank} waited {limit}s for {what} "
                    "(a dead or hung peer?)")

    def _join_round(self, req: Optional[Request]) -> dict:
        """Run one coordination round; ``req=None`` submits JOIN."""
        c = self.controller
        seq = self._join_seq
        self._join_seq += 1
        base = f"{c.ns}/jr/{seq}"
        is_join = req is None
        c.transport.set(f"{base}/req/{c.rank}",
                        self._JOIN_SENTINEL if is_join else req.encode())
        if c.rank == 0:
            resp = self._join_coordinate(base, seq, is_join)
        else:
            raw = self._join_wait(f"{base}/resp", is_join,
                                  f"rank 0's outcome of collective round "
                                  f"{seq}")
            if raw is None:
                raise HorovodInternalError(
                    f"no response for collective round {seq} within "
                    f"{c.timeout_s}s")
            c.transport.read_by(f"{base}/read", c.size - 1,
                                [f"{base}/resp"])
            resp = json.loads(raw)
        if not resp["ok"]:
            # The same failure raises the same type on every rank: a
            # divergence is a program bug (MismatchError naming the
            # ranks), a missing rank a runtime failure.
            if resp.get("kind") == "timeout":
                raise HorovodInternalError(resp["error"])
            raise MismatchError(resp["error"], ranks=resp.get("ranks", ()))
        return resp

    def _join_coordinate(self, base: str, seq: int, is_join: bool) -> dict:
        c = self.controller
        reqs: Dict[int, str] = {}
        error, error_kind = "", ""
        for r in range(c.size):
            raw = self._join_wait(f"{base}/req/{r}", is_join,
                                  f"rank {r}'s request of collective round "
                                  f"{seq}")
            if raw is None:
                error = (f"rank {r} did not participate in collective "
                         f"round {seq} within {c.timeout_s}s (stalled or "
                         "diverged program order)")
                error_kind = "timeout"
                break
            reqs[r] = raw
        for r in range(c.size):
            c.transport.delete(f"{base}/req/{r}")
        decoded: Dict[int, Request] = {}
        error_ranks: List[int] = []
        if not error:
            for r in sorted(reqs):
                if reqs[r] == self._JOIN_SENTINEL:
                    if r not in self._coord_joined:
                        self._coord_joined.append(r)
                else:
                    decoded[r] = Request.decode(reqs[r])
            if decoded:
                first = min(decoded)
                base_req = dataclasses.replace(decoded[first], rank=0)
                for r, d in decoded.items():
                    if dataclasses.replace(d, rank=0) != base_req:
                        error = (f"rank {r} submitted a mismatched "
                                 f"collective: expected {base_req}, got "
                                 f"{d}")
                        error_kind = "mismatch"
                        error_ranks.append(r)
                        break
                if (not error and self._coord_joined
                        and base_req.op_type != "allreduce"):
                    error = (f"{base_req.op_type} is not supported with "
                             "Join at this time")
                    error_kind = "mismatch"
        desc = reqs[min(decoded)] if (not error and decoded) else None
        resp = {"ok": not error, "error": error, "kind": error_kind,
                "ranks": error_ranks, "desc": desc,
                "joined": list(self._coord_joined),
                "all_joined": len(self._coord_joined) == c.size,
                "last": (self._coord_joined[-1] if self._coord_joined
                         else -1)}
        c.transport.set(f"{base}/resp", json.dumps(resp))
        return resp

    def _join_compression(self):
        """The engine-wide compression, which a joined process also
        applies to its zeros; join rounds ride uncompressed where it is
        the quantized reduction (no residual state to replay)."""
        comp = self._default_compression
        return NoneCompressor if getattr(comp, "quantized_reduce",
                                         False) else comp

    def _join_dispatch(self, req: Request, joined_ranks,
                       x: Optional[torch.Tensor] = None,
                       prescale: float = 1.0,
                       postscale: float = 1.0) -> torch.Tensor:
        """One join-aware allreduce: active processes contribute their
        tensor, joined ones zeros; AVERAGE divides by the active count.
        With nobody joined it is an ordinary allreduce of any op."""
        op = C.ReduceOp(req.reduce_op)
        if x is None:
            x = torch.zeros(tuple(req.shape), dtype=getattr(torch, req.dtype),
                            device=self.device)
        if joined_ranks and op not in (C.ReduceOp.SUM, C.ReduceOp.AVERAGE):
            raise TensorShapeMismatchError(
                f"allreduce op {op.name} is not supported while a rank "
                "has joined (JoinOp substitutes zeros, which only "
                "composes with SUM/AVERAGE)")
        comp = self._join_compression()
        w, ctx = comp.compress(x)
        if not joined_ranks:
            y = C.allreduce(w, op, prescale, postscale)
        else:
            w = C._apply_scale(w, prescale)
            y = C.join_allreduce(w, self.rank in joined_ranks,
                                 self.size - len(joined_ranks), op)
            y = C._apply_scale(y, postscale)
        return comp.decompress(y, ctx)

    def join(self) -> int:
        """Mark this process joined; keep taking part in the remaining
        processes' allreduces with zero tensors until every process has
        joined. Returns the last-joined rank. Without join mode (or in a
        world of one) every rank is at the same program point and it
        returns ``size - 1``."""
        if not self.join_active():
            return self.size - 1
        while True:
            resp = self._join_round(None)
            if resp.get("desc"):
                self._join_dispatch(Request.decode(resp["desc"]),
                                    set(resp["joined"]))
            if resp["all_joined"]:
                return int(resp["last"])

    def _allreduce_join_mode(self, x, op, name, prescale, postscale,
                             compression) -> _Pending:
        if compression is not self._default_compression:
            # A joined process replays this collective knowing only the
            # engine-wide compression.
            raise ValueError(
                "per-call compression is not supported in join mode; "
                "configure it engine-wide (init(compression=...))")
        full = self._begin(name, "allreduce")
        try:
            req = Request(self.rank, "allreduce", full,
                          dtype_name(x.dtype), tuple(x.shape), int(op))
            resp = self._join_round(req)
            y = self._join_dispatch(req, set(resp["joined"]), x, prescale,
                                    postscale)
        except Exception as e:
            self._fail(full, e)
            raise
        return self._pending(full, C._done(y))

    # -- allreduce -------------------------------------------------------

    @staticmethod
    def _cast_reduce(x, op, prescale, postscale, cast) -> C.Issued:
        """The allreduce of ``x`` with a cast compressor around it."""
        w, ctx = cast.compress(x)
        works, finish = C.allreduce_issue(w, op, prescale, postscale)
        return works, lambda: cast.decompress(finish(), ctx)

    @staticmethod
    def _quantized_reduce(x, op, prescale, postscale) -> C.Issued:
        y = C.quantized_allreduce(C._apply_scale(x, prescale), op)
        return C._done(C._apply_scale(y, postscale))

    def allreduce(self, x: torch.Tensor, op=C.ReduceOp.AVERAGE,
                  name: Optional[str] = None, prescale_factor: float = 1.0,
                  postscale_factor: float = 1.0,
                  compression=None) -> _Pending:
        op = C.ReduceOp(op)
        if compression is None:
            compression = self._default_compression
        if self.join_active():
            return self._allreduce_join_mode(x, op, name, prescale_factor,
                                             postscale_factor, compression)
        full = self._begin(name, "allreduce")
        try:
            self._negotiate("allreduce", full, x, reduce_op=int(op),
                            wire=self._wire_contract(compression))
            quantized = getattr(compression, "quantized_reduce", False)
            linear_float = (op in (C.ReduceOp.SUM, C.ReduceOp.AVERAGE)
                            and x.is_floating_point())
            nbytes = _nbytes(x)
            # The int8_ef default: a large float payload rides the
            # quantized allreduce, a small fp32 one the bf16 cast,
            # anything else uncompressed (int8_ef's compress() is a wire
            # format that cannot enter a sum).
            quant = (quantized and linear_float
                     and nbytes >= self.config.quantize_min_bucket_bytes)
            small_bf16 = (quantized and linear_float and not quant
                          and x.element_size() > 2)
            cast = BF16Compressor if small_bf16 else (
                NoneCompressor if quantized else compression)
            cast_dt = getattr(cast, "wire_dtype", None)
            if quant:
                wire, wire_bytes = "int8", _wire_bytes_int8(x.numel())
            elif cast_dt is not None and x.dtype in (torch.float32,
                                                     torch.float64):
                wire = "bf16" if cast_dt == torch.bfloat16 else "fp16"
                wire_bytes = x.numel() * 2
            else:
                wire, wire_bytes = "none", nbytes
            _count_bytes("allreduce", nbytes, wire_bytes)
            if _METRICS_ON:
                _M_AR_WIRE.labels(wire=wire, axis="flat").inc(wire_bytes)
            flightrec_lib.recorder().annotate(full, nbytes=nbytes,
                                              wire=wire)
            if quant:
                issued = self._quantized_reduce(x, op, prescale_factor,
                                                postscale_factor)
            else:
                issued = self._cast_reduce(x, op, prescale_factor,
                                           postscale_factor, cast)
        except Exception as e:
            self._fail(full, e)
            raise
        return self._pending(full, issued)

    def allreduce_tree(self, tensors: Sequence[torch.Tensor],
                       op=C.ReduceOp.AVERAGE, name: Optional[str] = None,
                       compression=None, prescale_factor: float = 1.0,
                       postscale_factor: float = 1.0) -> _Pending:
        """Fused allreduce of a list of tensors: one collective per
        fusion bucket of at most ``config.fusion_threshold_bytes``
        (``common/fusion.py``); pre/postscale per bucket. The result is
        the list of reduced tensors."""
        op = C.ReduceOp(op)
        if compression is None:
            compression = self._default_compression
        leaves = list(tensors)
        if self.join_active():
            # A joined process replays single allreduces, so join mode
            # reduces leaf by leaf.
            pend = [self._allreduce_join_mode(
                        leaf, op, f"{name or 'grouped'}.leaf{i}",
                        prescale_factor, postscale_factor, compression)
                    for i, leaf in enumerate(leaves)]
            return _Pending(self, None, [], lambda: [p.wait() for p in pend])
        full = self._begin(name, "grouped_allreduce")
        try:
            # One request carries one shape: the leaves' signature rides
            # the shape field as (leaves, elements, crc32 of their
            # shapes and dtypes), under the plain name, so diverged ranks
            # meet in one round.
            meta = repr([(tuple(leaf.shape), dtype_name(leaf.dtype))
                         for leaf in leaves])
            total = sum(leaf.numel() for leaf in leaves)
            self._negotiate("allreduce", full, leaves[0], reduce_op=int(op),
                            shape=(len(leaves), total,
                                   zlib.crc32(meta.encode())),
                            wire=self._wire_contract(compression))
            quantized = getattr(compression, "quantized_reduce", False)
            quant = quantized and op in (C.ReduceOp.SUM, C.ReduceOp.AVERAGE)
            plan = fusion_lib.plan_fusion(leaves,
                                          self.config.fusion_threshold_bytes)
            if quant:
                plan = fusion_lib.assign_wire_dtypes(
                    plan, self.config.quantize_min_bucket_bytes)
            flats = fusion_lib.fuse(leaves, plan)
            issued = []
            for i, flat in enumerate(flats):
                wire = plan.wire_dtypes[i] if quant else None
                if wire == fusion_lib.WIRE_INT8 and flat.is_floating_point():
                    issued.append(self._quantized_reduce(
                        flat, op, prescale_factor, postscale_factor))
                    continue
                cast = BF16Compressor if (wire == fusion_lib.WIRE_BF16
                                          and flat.is_floating_point()) \
                    else (NoneCompressor if quantized else compression)
                issued.append(self._cast_reduce(
                    flat, op, prescale_factor, postscale_factor, cast))
            _count_bytes("grouped_allreduce", sum(_nbytes(f) for f in flats))
            works = [w for ws, _ in issued for w in ws]
        except Exception as e:
            self._fail(full, e)
            raise
        return self._pending(full, (works, lambda: fusion_lib.unfuse(
            [finish() for _, finish in issued], plan)))

    # -- gathers, broadcast, exchanges ----------------------------------

    def _issue(self, kind: str, name: Optional[str], negotiate: dict,
               issue) -> _Pending:
        """The common shape of a collective: begin, negotiate, issue."""
        full = self._begin(name, kind)
        try:
            self._negotiate(name=full, **negotiate)
            issued = issue(full)
        except Exception as e:
            self._fail(full, e)
            raise
        return self._pending(full, issued)

    def allgather(self, x: torch.Tensor, name: Optional[str] = None
                  ) -> _Pending:
        """Every rank's ``x`` concatenated along dim 0; every rank must
        hold the same shape (see :meth:`allgatherv` for ragged rows)."""
        def issue(full):
            _count_bytes("allgather", _nbytes(x))
            return C.allgather_issue(x)
        return self._issue("allgather", name,
                           {"op_type": "allgather", "x": x}, issue)

    def allgatherv(self, x: torch.Tensor, name: Optional[str] = None
                   ) -> _Pending:
        """Ragged allgather: every rank's rows (any count) concatenated
        along dim 0 in rank order. The trailing shape and dtype are
        negotiated; the row counts are exchanged through the controller
        on every call (the reference's tensor-shape negotiation)."""
        def issue(full):
            rows = int(x.shape[0])
            if self.controller is not None:
                counts = [int(json.loads(v)) for v in
                          self.controller.exchange(full, json.dumps(rows))]
            else:
                counts = [rows]
            _count_bytes("allgather", _nbytes(x))
            return C.allgatherv_issue(x, counts)
        return self._issue("allgather", name,
                           {"op_type": "allgatherv", "x": x,
                            "shape": tuple(x.shape[1:])}, issue)

    def broadcast(self, x: torch.Tensor, root_rank: int = 0,
                  name: Optional[str] = None) -> _Pending:
        def issue(full):
            _count_bytes("broadcast", _nbytes(x))
            return C.broadcast_issue(x, root_rank)
        return self._issue("broadcast", name,
                           {"op_type": "broadcast", "x": x,
                            "root_rank": root_rank}, issue)

    def _resolve_a2a_wire(self, wire, nbytes: int, dtype) -> str:
        """The alltoall ``wire`` argument (None, a format name or a
        ``Compression`` class) as a wire format; ``"auto"`` applies the
        quantize-min threshold. Non-float payloads ride uncompressed. The
        same on every rank for the same argument and payload."""
        if wire is None:
            return "none"
        if isinstance(wire, type):
            if issubclass(wire, Int8Compressor):
                wire = "int8"
            else:
                wd = getattr(wire, "wire_dtype", None)
                if wd == torch.float16:
                    raise ValueError("fp16 is not an alltoall wire format; "
                                     "use bf16")
                wire = "bf16" if wd is not None else "none"
        wire = str(wire)
        if wire == "auto":
            wire = fusion_lib.assign_alltoall_wire(
                nbytes, self.config.quantize_min_bucket_bytes)
        if wire == "fp32":
            wire = "none"
        if wire not in C.WIRES:
            raise ValueError(f"unknown alltoall wire format {wire!r}; "
                             "choose none/bf16/int8/auto")
        if wire != "none" and not dtype.is_floating_point:
            return "none"
        return wire

    def alltoall(self, x: torch.Tensor, name: Optional[str] = None,
                 splits=None, chunked: Optional[bool] = None,
                 wire=None) -> _Pending:
        """Even all-to-all: dim 0 splits into ``size`` equal chunks, chunk
        ``j`` to rank ``j``. ``wire`` compresses the exchanged payload:
        ``"bf16"`` cast, ``"int8"`` block-scaled through K2/K4, ``"auto"``
        by size, or a ``Compression`` class; it is part of the
        negotiated contract. With ``splits`` (this rank's send counts),
        the uneven :meth:`alltoallv`."""
        if splits is not None:
            return self.alltoallv(x, splits, name, chunked=chunked,
                                  wire=wire)
        w = self._resolve_a2a_wire(wire, _nbytes(x), x.dtype)

        def issue(full):
            elems = x.numel()
            wire_bytes = (_wire_bytes_int8(elems) if w == "int8" else
                          elems * 2 if w == "bf16" else _nbytes(x))
            _count_bytes("alltoall", _nbytes(x), wire_bytes)
            if _METRICS_ON:
                _M_A2A_WIRE.labels(wire=w, axis="flat").inc(
                    (self.size - 1) / self.size * wire_bytes)
            flightrec_lib.recorder().annotate(full, nbytes=wire_bytes,
                                              wire=w)
            return C.compressed_alltoall_issue(x, w)
        return self._issue("alltoall", name,
                           {"op_type": "alltoall", "x": x, "wire": w},
                           issue)

    def alltoallv(self, x: torch.Tensor, splits, name: Optional[str] = None,
                  chunked: Optional[bool] = None, wire=None) -> _Pending:
        """Uneven all-to-all: ``splits[d]`` consecutive rows of ``x`` go
        to rank ``d``; the receive counts come from the negotiation (every
        rank's split vector is exchanged through the controller, the
        reference's AlltoallGetRecvSplits). Returns the rows received,
        in source-rank order."""
        if wire == "auto":
            raise ValueError(
                "alltoallv does not support wire='auto': the size "
                "threshold is rank-local and uneven per-rank sends "
                "would resolve different wire formats across ranks; "
                "pass an explicit format")
        w = self._resolve_a2a_wire(wire, _nbytes(x), x.dtype)
        if chunked or w != "none":
            raise NotImplementedError(
                "the chunked alltoallv and its wire formats are not "
                "ported yet; they come with slice 3b (mesh routing) of "
                "the port")
        my_splits = [int(s) for s in splits]
        if len(my_splits) != self.size:
            raise TensorShapeMismatchError(
                f"splits must have length {self.size}, got "
                f"{len(my_splits)}")
        if sum(my_splits) != x.shape[0]:
            raise TensorShapeMismatchError(
                f"sum(splits)={sum(my_splits)} != send rows {x.shape[0]}")

        def issue(full):
            if self.controller is not None:
                matrix = [json.loads(r) for r in self.controller.exchange(
                    full, json.dumps(my_splits))]
            else:
                matrix = [my_splits]
            recv = [row[self.rank] for row in matrix]
            _count_bytes("alltoall", _nbytes(x))
            return C.alltoallv_issue(x, my_splits, recv)
        return self._issue("alltoall", name,
                           {"op_type": "alltoallv", "x": x,
                            "shape": tuple(x.shape[1:]),
                            "reduce_op": {None: 0, False: 1}[chunked],
                            "wire": w}, issue)

    def reducescatter(self, x: torch.Tensor, op=C.ReduceOp.AVERAGE,
                      name: Optional[str] = None) -> _Pending:
        """This rank's 1/size slice (along dim 0) of the elementwise SUM
        or AVERAGE over ranks."""
        op = C.ReduceOp(op)

        def issue(full):
            _count_bytes("reducescatter", _nbytes(x))
            return C.reducescatter_issue(x, op)
        return self._issue("reducescatter", name,
                           {"op_type": "reducescatter", "x": x,
                            "reduce_op": int(op)}, issue)

    def barrier(self) -> None:
        if self.join_active():
            # A lockstep round keeps a joined process in step; rank 0
            # refuses it once a rank has joined.
            self._join_round(Request(self.rank, "barrier", "barrier",
                                     "int32", (), 0, -1))
        dist.barrier()

    # -- async handle surface -------------------------------------------

    def async_call(self, fn, *args, **kwargs) -> int:
        return self.handles.allocate(fn(*args, **kwargs))

    def poll(self, handle: int) -> bool:
        return self.handles.poll(handle)

    def synchronize(self, handle: int):
        return self.handles.synchronize(handle)

    def drain(self) -> None:
        """Synchronize every outstanding handle (their errors are dropped:
        this runs on the way out, at ``shutdown()``)."""
        for h in self.handles.outstanding():
            try:
                self.handles.synchronize(h)
            except Exception as e:  # noqa: BLE001 - draining at shutdown
                logger.warning("shutdown: handle %d failed: %r", h, e)
