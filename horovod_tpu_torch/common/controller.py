"""Controller — cross-rank validation of eager collectives, the port of
``horovod_tpu/common/controller.py``.

Each process issues its collectives itself, and ``torch.distributed``
pairs them by order: if two ranks submit different collectives (another
shape, dtype, op or wire) under one tensor name, the exchange hangs or
reads garbage. So before the engine dispatches a new collective
signature, every rank publishes a :class:`Request` to a key-value store,
rank 0 gathers them, checks that they match field by field and publishes
a :class:`Response`; a mismatch raises :class:`MismatchError` naming the
offending ranks on every rank instead of a hang, and a rank that never
submits raises :class:`HorovodInternalError` after ``timeout_s``. A
signature seen before skips the round (the reference's response-cache
fast path), so a training loop negotiates each gradient once.

The store is pluggable: :class:`StoreTransport` runs over the c10d store
of ``init()``'s process group, :class:`InMemoryTransport` over a dict for
tests with ranks on threads. Keys are namespaced per ``init()``
generation and deleted once every rank that reads them has read them.

Requests and responses travel in the native wire codec (``"w:"`` and the
base64 of ``native/wire.cc``'s packed bytes, the JAX package's format)
when the library is in use and the fields fit it, else as JSON (``"j:"``):
a request carrying ``wire_dtype`` or ``process_set``, and a failed
response carrying ``kind``/``ranks``, always ride JSON, and
``HVD_TPU_WIRE_FORMAT=json`` forces JSON everywhere. Decoding dispatches
on the prefix, so ranks with and without the library interoperate; a
``"w:"`` frame on a rank without it raises. :data:`FRAMES` counts the
frames this process encoded by form.
"""

from __future__ import annotations

import base64
import dataclasses
import datetime
import hashlib
import json
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from .. import native
from ..native import NegotiationTable
from .config import runtime_env
from .exceptions import (HorovodInternalError, MismatchError,
                         TensorShapeMismatchError)

#: Frames encoded by this process: ``native`` (``"w:"``), ``json`` (a
#: request or response that could have ridden the native codec but the
#: library is off or the format is forced) and ``json_ext`` (one whose
#: extension fields only JSON carries).
FRAMES = {"native": 0, "json": 0, "json_ext": 0}
_NATIVE_LOST = ("peer encoded its {what} with the native wire codec but "
                "this rank runs without the native library "
                "(HVD_TPU_DISABLE_NATIVE=1) — set HVD_TPU_WIRE_FORMAT=json "
                "on ALL ranks")


def _native_wire() -> bool:
    return runtime_env("WIRE_FORMAT") != "json" and native.available()


@dataclasses.dataclass(frozen=True)
class Request:
    """One rank's collective signature (reference message.h Request).
    ``wire_dtype`` tags the reduction compression or wire format and
    ``process_set`` the engine's scope: ranks that agree on shape, dtype
    and op but not on these would still exchange mismatched buffers."""

    rank: int
    op_type: str          # "allreduce" | "allgather" | ...
    tensor_name: str
    dtype: str
    shape: Tuple[int, ...]
    reduce_op: int = 0
    root_rank: int = -1
    wire_dtype: str = ""
    process_set: str = ""

    def signature(self) -> str:
        return json.dumps([self.op_type, self.tensor_name, self.dtype,
                           list(self.shape), self.reduce_op,
                           self.root_rank, self.wire_dtype,
                           self.process_set])

    def encode(self) -> str:
        """The native frame (``"w:"``) when the library is in use and the
        op, dtype and shape fit its tables, else JSON (``"j:"``)."""
        if self.wire_dtype or self.process_set:
            FRAMES["json_ext"] += 1
        elif _native_wire():
            data = native.encode_request(
                self.rank, self.op_type, self.reduce_op, self.root_rank,
                self.dtype, self.tensor_name, self.shape)
            if data is not None:
                FRAMES["native"] += 1
                return "w:" + base64.b64encode(data).decode()
            FRAMES["json"] += 1
        else:
            FRAMES["json"] += 1
        return "j:" + json.dumps(dataclasses.asdict(self))

    @classmethod
    def decode(cls, raw: str) -> "Request":
        if raw.startswith("w:"):
            if not native.available():
                raise HorovodInternalError(_NATIVE_LOST.format(
                    what="request"))
            tup = native.decode_request(base64.b64decode(raw[2:]))
            if tup is None:
                raise HorovodInternalError(
                    f"undecodable wire request: {raw[:80]!r}")
            rank, op_type, reduce_op, root_rank, dtype, name, shape = tup
            return cls(rank, op_type, name, dtype, tuple(shape), reduce_op,
                       root_rank)
        if not raw.startswith("j:"):
            raise HorovodInternalError(f"undecodable request {raw[:80]!r}")
        d = json.loads(raw[2:])
        d["shape"] = tuple(d["shape"])
        return cls(**d)


@dataclasses.dataclass
class Response:
    """Rank 0's verdict on a round (reference message.h Response):
    ``kind`` is "mismatch" or "timeout" on failure and ``ranks`` the
    offending ranks."""

    ok: bool
    tensor_name: str
    error: str = ""
    kind: str = ""
    ranks: Tuple[int, ...] = ()

    def encode(self) -> str:
        """The native frame (``ok``, name, error) unless ``kind`` or
        ``ranks`` are set (JSON carries them), the library is off or JSON
        is forced."""
        if self.kind or self.ranks:
            FRAMES["json_ext"] += 1
        elif _native_wire():
            data = native.encode_response(self.ok, self.tensor_name,
                                          self.error)
            if data is not None:
                FRAMES["native"] += 1
                return "w:" + base64.b64encode(data).decode()
            FRAMES["json"] += 1
        else:
            FRAMES["json"] += 1
        d = dataclasses.asdict(self)
        d["ranks"] = list(self.ranks)
        return "j:" + json.dumps(d)

    @classmethod
    def decode(cls, raw: str) -> "Response":
        if raw.startswith("w:"):
            if not native.available():
                raise HorovodInternalError(_NATIVE_LOST.format(
                    what="response"))
            tup = native.decode_response(base64.b64decode(raw[2:]))
            if tup is None:
                raise HorovodInternalError(
                    f"undecodable wire response: {raw[:80]!r}")
            return cls(*tup)
        d = json.loads(raw[2:])
        return cls(d["ok"], d["tensor_name"], d.get("error", ""),
                   d.get("kind", ""), tuple(d.get("ranks", ())))


class KVTransport:
    """A blocking key-value store for the negotiation rounds."""

    def set(self, key: str, value: str) -> None:
        raise NotImplementedError

    def get(self, key: str, timeout_s: float) -> Optional[str]:
        """The value, or None when ``key`` is not set within
        ``timeout_s`` (0 = a poll)."""
        raise NotImplementedError

    def add(self, key: str, amount: int) -> int:
        """Atomically add to an integer key; returns the new value."""
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def read_by(self, counter: str, readers: int,
                keys: Iterable[str]) -> None:
        """Record one read of ``keys``; the last of ``readers`` readers
        deletes them and the counter."""
        if self.add(counter, 1) == readers:
            for key in keys:
                self.delete(key)
            self.delete(counter)


class InMemoryTransport(KVTransport):
    """All ranks share one dict (tests run ranks on threads)."""

    def __init__(self):
        self._data: Dict[str, str] = {}
        self._cond = threading.Condition()

    def set(self, key: str, value: str) -> None:
        with self._cond:
            self._data[key] = value
            self._cond.notify_all()

    def get(self, key: str, timeout_s: float) -> Optional[str]:
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while key not in self._data:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)
            return self._data[key]

    def add(self, key: str, amount: int) -> int:
        with self._cond:
            value = int(self._data.get(key, "0")) + amount
            self._data[key] = str(value)
            self._cond.notify_all()
            return value

    def delete(self, key: str) -> None:
        with self._cond:
            self._data.pop(key, None)


class StoreTransport(KVTransport):
    """The c10d store of ``init()``'s process group (a ``TCPStore`` that
    rank 0 serves, or the in-process store of a world of one):
    ``get`` is ``store.wait`` then ``store.get``, None on a timeout."""

    def __init__(self, store):
        self._store = store

    def set(self, key: str, value: str) -> None:
        self._store.set(key, value)

    def get(self, key: str, timeout_s: float) -> Optional[str]:
        try:
            if timeout_s <= 0:
                if not self._store.check([key]):
                    return None
            else:
                self._store.wait([key],
                                 datetime.timedelta(seconds=timeout_s))
            return self._store.get(key).decode()
        except RuntimeError as e:
            # Only a timeout means "not submitted"; a lost store (dead
            # rank 0) must surface as itself.
            if "timeout" in str(e).lower():
                return None
            raise HorovodInternalError(
                f"c10d store failure reading {key}: {e}") from e

    def add(self, key: str, amount: int) -> int:
        return int(self._store.add(key, amount))

    def delete(self, key: str) -> None:
        self._store.delete_key(key)


def _hashed(name: str) -> str:
    return hashlib.sha1(name.encode()).hexdigest()[:16]


class Controller:
    """Negotiates eager-collective signatures across processes."""

    def __init__(self, rank: int, size: int, transport: KVTransport,
                 timeout_s: float = 60.0, namespace: str = "hvd_tpu/ctl",
                 incarnation: int = 0):
        """``incarnation`` scopes the keys per ``init()`` generation, so a
        controller never reads an earlier generation's rounds; every rank
        of a world passes the same value."""
        self.rank = rank
        self.size = size
        self.transport = transport
        self.timeout_s = timeout_s
        self.ns = f"{namespace}/i{incarnation}"
        # Every rank must agree on what is cached, or one rank takes the
        # fast path while another posts a request nobody answers: an
        # unbounded set, never evicted.
        self._cache: set = set()
        self._name_seq: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._table = NegotiationTable(size) if rank == 0 else None
        #: Store rounds made by :meth:`negotiate` (cache hits make none).
        self.negotiation_rounds = 0

    def _next_seq(self, tag: str) -> int:
        with self._lock:
            seq = self._name_seq.get(tag, 0)
            self._name_seq[tag] = seq + 1
        return seq

    def negotiate(self, req: Request) -> Response:
        """Check that every rank submitted a matching request. A
        signature seen before returns at once, with no store round."""
        sig = req.signature()
        with self._lock:
            if sig in self._cache:
                return Response(True, req.tensor_name)
        if self.size == 1:
            with self._lock:
                self._cache.add(sig)
            return Response(True, req.tensor_name)

        # A round is keyed by the tensor name and its per-name sequence,
        # not by the signature: ranks that diverged must meet in the same
        # round for rank 0 to see the mismatch.
        seq = self._next_seq(req.tensor_name)
        base = f"{self.ns}/{_hashed(req.tensor_name)}/{seq}"
        self.negotiation_rounds += 1
        self.transport.set(f"{base}/req/{self.rank}", req.encode())
        if self.rank == 0:
            resp = self._coordinate(req, base)
        else:
            raw = self.transport.get(f"{base}/resp", self.timeout_s)
            if raw is None:
                raise HorovodInternalError(
                    f"controller response timeout after {self.timeout_s}s "
                    f"for {req.tensor_name}")
            resp = Response.decode(raw)
            self.transport.read_by(f"{base}/read", self.size - 1,
                                   [f"{base}/resp"])

        if resp.ok:
            with self._lock:
                self._cache.add(sig)
        elif resp.kind == "mismatch":
            raise MismatchError(resp.error, ranks=resp.ranks)
        elif resp.kind == "timeout":
            # A missing rank is a runtime failure (a dead or hung peer),
            # not a program bug.
            raise HorovodInternalError(resp.error)
        else:
            raise TensorShapeMismatchError(resp.error)
        return resp

    def _coordinate(self, req: Request, base: str) -> Response:
        """Rank 0: gather every rank's request to completion (so the
        report names every offending rank), compare, publish."""
        mine = dataclasses.replace(req, rank=0)
        error, kind = "", ""
        offenders: List[int] = []
        first_bad: Optional[Request] = None
        for r in range(self.size):
            raw = self.transport.get(f"{base}/req/{r}", self.timeout_s)
            if raw is None:
                # Poll the ranks not gathered yet, so the report names
                # only the ranks really missing.
                for r2 in range(r + 1, self.size):
                    if self.transport.get(f"{base}/req/{r2}",
                                          0.0) is not None:
                        self._table.increment(base, r2)
                missing = self._table.missing_ranks(base) or [r]
                error = (f"ranks {missing} did not submit a collective "
                         f"within {self.timeout_s}s (stalled or diverged "
                         "program order)")
                kind = "timeout"
                offenders = list(missing)
                break
            self._table.increment(base, r)
            other = Request.decode(raw)
            if dataclasses.replace(other, rank=0) != mine:
                offenders.append(r)
                if first_bad is None:
                    first_bad = other
        if not error and offenders:
            kind = "mismatch"
            error = (f"ranks {offenders} submitted a mismatched collective: "
                     f"expected {mine}, e.g. rank {offenders[0]} sent "
                     f"{first_bad}")
        for r in range(self.size):
            self.transport.delete(f"{base}/req/{r}")
        resp = Response(not error, req.tensor_name, error, kind,
                        tuple(offenders))
        self.transport.set(f"{base}/resp", resp.encode())
        return resp

    def exchange(self, tag: str, value: str) -> List[str]:
        """All-gather of one small string per rank through the store (the
        reference's AlltoallGetRecvSplits transport); returns the values
        in rank order. Every call is a fresh round."""
        seq = self._next_seq("exch:" + tag)
        base = f"{self.ns}/exch/{_hashed(tag)}/{seq}"
        self.transport.set(f"{base}/{self.rank}", value)
        keys = [f"{base}/{r}" for r in range(self.size)]
        out: List[str] = []
        for r, key in enumerate(keys):
            raw = self.transport.get(key, self.timeout_s)
            if raw is None:
                raise HorovodInternalError(
                    f"rank {r} did not publish its value for exchange "
                    f"{tag!r} within {self.timeout_s}s")
            out.append(raw)
        self.transport.read_by(f"{base}/read", self.size, keys)
        return out

    def agree(self, tag: str, value: str) -> List[int]:
        """One :meth:`exchange` round; returns the ranks whose ``value``
        differs from this rank's (empty when all agree). A rank that does
        not take part makes the others raise ``HorovodInternalError``
        after the timeout."""
        return [r for r, v in enumerate(self.exchange(tag, value))
                if v != value]

    def cache_size(self) -> int:
        with self._lock:
            return len(self._cache)
