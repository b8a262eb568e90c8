"""The port's native host runtime — ``ctypes`` bindings over its own C++
copy of ``horovod_tpu/native/*.cc`` (host code, not a TPU kernel).

The sources live beside this file (``controller_core.cc``, ``wire.cc``,
``fusion_planner.cc``, ``timeline.cc``, ``gp_core.cc``). At first use
they are compiled with ``g++ -O2 -std=c++17 -fPIC -pthread -shared`` into
``build/horovod_tpu_torch/native/`` beside the package (``.gitignore``
lists ``build/``), named by a hash of the sources and the flags, so an
edited source rebuilds and nothing is ever written into the package.

What the library serves, each with its Python counterpart kept here:

* the controller's wire codec (:func:`encode_request` ...): requests and
  responses as packed little-endian bytes, byte-identical to the JAX
  package's codec for the same fields;
* :class:`NegotiationTable` (rank 0's record of which ranks reported a
  round) and :class:`ResponseCacheNative` (the eager engine's bounded LRU
  of signatures);
* the fusion planner (:func:`plan_fusion_native`), the autotuner's GP/EI
  core (:func:`gp_ei_native`) and the chrome-trace writer
  (:class:`NativeTimelineWriter`: an MPSC ring drained by a writer
  thread, dropping and counting events when full).

``HVD_TPU_DISABLE_NATIVE=1`` selects the Python paths, as in the JAX
package. Otherwise a failed build or load RAISES with the compiler's
output: the JAX loader logs a warning and falls back, but the port takes
no silent fallback from a native or device path.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from ..common.config import runtime_env

SOURCES = ("timeline.cc", "wire.cc", "fusion_planner.cc",
           "controller_core.cc", "gp_core.cc")
SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "horovod_tpu_torch" / "native"
CXX = "g++"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def disabled() -> bool:
    """``HVD_TPU_DISABLE_NATIVE=1``: every consumer takes its Python
    path."""
    return runtime_env("DISABLE_NATIVE") == "1"


def library_path() -> Path:
    """Where :func:`build` puts the library (named by a hash of the
    sources, the compiler and its flags)."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((SOURCE_DIR / name).read_bytes())
    h.update(" ".join((CXX,) + tuple(CXX_FLAGS)).encode())
    return BUILD_DIR / f"libhvdtpu_torch_native.{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources into the library once per hash and return its
    path; raises with the compiler's output on failure. Safe under
    concurrent callers: each compiles to a private name and renames it
    into place."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp),
           *(str(SOURCE_DIR / name) for name in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native build failed to run ({' '.join(cmd)}): "
                           f"{e}; set HVD_TPU_DISABLE_NATIVE=1 to run "
                           "the Python paths") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"native build failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}\nset HVD_TPU_DISABLE_NATIVE=1 "
            "to run the Python paths")
    os.replace(tmp, out)
    return out


def load() -> Optional[ctypes.CDLL]:
    """The loaded library (building it at first use), or None when
    :func:`disabled`. Raises when the build or the load fails."""
    global _lib
    if disabled():
        return None
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _bind_signatures(lib)
            _lib = lib
        return _lib


def available() -> bool:
    """True when the library is in use (not disabled); raises when it
    should be and cannot be built or loaded."""
    return load() is not None


def _bind_signatures(lib: ctypes.CDLL) -> None:
    c = ctypes
    i64p, i32p, u8p = (c.POINTER(c.c_int64), c.POINTER(c.c_int32),
                       c.POINTER(c.c_uint8))
    dp = c.POINTER(c.c_double)
    sigs = {
        "hvt_timeline_start": ([c.c_char_p], c.c_int),
        "hvt_timeline_event": ([c.c_char_p, c.c_char_p, c.c_char,
                                c.c_double], None),
        "hvt_timeline_stop": ([], c.c_int),
        "hvt_timeline_dropped": ([], c.c_uint64),
        "hvt_plan_fusion": ([c.c_int64, i64p, i32p, i32p, c.c_int64, i32p],
                            c.c_int64),
        "hvt_encode_request": ([c.c_int32, c.c_uint8, c.c_uint8, c.c_int32,
                                c.c_uint8, c.c_char_p, i64p, c.c_uint8, u8p,
                                c.c_int64], c.c_int64),
        "hvt_decode_request": ([u8p, c.c_int64, i32p, u8p, u8p, i32p, u8p,
                                c.c_char_p, c.c_int64, i64p, u8p,
                                c.c_uint8], c.c_int64),
        "hvt_encode_response": ([c.c_uint8, c.c_char_p, c.c_char_p, u8p,
                                 c.c_int64], c.c_int64),
        "hvt_decode_response": ([u8p, c.c_int64, u8p, c.c_char_p,
                                 c.c_int64, c.c_char_p, c.c_int64],
                                c.c_int64),
        "hvd_nt_new": ([c.c_int], c.c_void_p),
        "hvd_nt_free": ([c.c_void_p], None),
        "hvd_nt_increment": ([c.c_void_p, c.c_char_p, c.c_int], c.c_int),
        "hvd_nt_pending": ([c.c_void_p], c.c_int64),
        "hvd_nt_missing": ([c.c_void_p, c.c_char_p, u8p, c.c_int], c.c_int),
        "hvd_lru_new": ([c.c_int64], c.c_void_p),
        "hvd_lru_free": ([c.c_void_p], None),
        "hvd_lru_lookup": ([c.c_void_p, c.c_char_p], c.c_int),
        "hvd_lru_put": ([c.c_void_p, c.c_char_p, c.c_char_p, c.c_int],
                        c.c_int),
        "hvd_lru_size": ([c.c_void_p], c.c_int64),
        "hvd_lru_erase": ([c.c_void_p, c.c_char_p], None),
        "hvd_gp_ei": ([dp, dp, c.c_int64, c.c_int64, dp, c.c_int64,
                       c.c_double, c.c_double, c.c_double, dp, dp],
                      c.c_int64),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


# -- fusion planner --------------------------------------------------------

def plan_fusion_native(elem_counts: Sequence[int],
                       dtype_codes: Sequence[int],
                       itemsizes: Sequence[int],
                       threshold_bytes: int) -> Optional[List[int]]:
    """Bucket ids per leaf in visit order (greedy same-dtype buckets up to
    the threshold), or None when the library is disabled."""
    lib = load()
    if lib is None:
        return None
    n = len(elem_counts)
    out = (ctypes.c_int32 * n)()
    lib.hvt_plan_fusion(n, (ctypes.c_int64 * n)(*elem_counts),
                        (ctypes.c_int32 * n)(*dtype_codes),
                        (ctypes.c_int32 * n)(*itemsizes), threshold_bytes,
                        out)
    return list(out)


# -- wire format -----------------------------------------------------------

OP_CODES = {"allreduce": 0, "allgather": 1, "broadcast": 2, "alltoall": 3,
            "reducescatter": 4, "barrier": 5, "join": 6}
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2, "float64": 3,
               "int32": 4, "int64": 5, "int8": 6, "uint8": 7, "bool": 8}
_OP_NAMES = {v: k for k, v in OP_CODES.items()}
_DTYPE_NAMES = {v: k for k, v in DTYPE_CODES.items()}


def encode_request(rank: int, op_type: str, reduce_op: int, root_rank: int,
                   dtype: str, name: str,
                   shape: Sequence[int]) -> Optional[bytes]:
    """The packed request, or None when disabled or when a field does not
    fit the format (an op or dtype outside the tables, a name past 64
    KiB, more than 255 dims). The caller then sends JSON."""
    lib = load()
    if lib is None or op_type not in OP_CODES or dtype not in DTYPE_CODES:
        return None
    ndim = len(shape)
    shp = (ctypes.c_int64 * max(ndim, 1))(*shape)
    raw = name.encode()
    cap = 64 + len(raw) + 8 * ndim
    buf = (ctypes.c_uint8 * cap)()
    n = lib.hvt_encode_request(rank, OP_CODES[op_type], reduce_op,
                               root_rank, DTYPE_CODES[dtype], raw, shp,
                               ndim, buf, cap)
    return bytes(buf[:n]) if n >= 0 else None


def decode_request(data: bytes) -> Optional[Tuple]:
    """``(rank, op_type, reduce_op, root_rank, dtype, name, shape)``, or
    None for bytes that are not a request of the format."""
    lib = load()
    if lib is None:
        return None
    buf = (ctypes.c_uint8 * max(len(data), 1)).from_buffer_copy(
        data or b"\0")
    rank, root = ctypes.c_int32(), ctypes.c_int32()
    op, rop, dt, ndim = (ctypes.c_uint8(), ctypes.c_uint8(),
                         ctypes.c_uint8(), ctypes.c_uint8())
    name = ctypes.create_string_buffer(65536)
    shape = (ctypes.c_int64 * 32)()
    rc = lib.hvt_decode_request(
        buf, len(data), ctypes.byref(rank), ctypes.byref(op),
        ctypes.byref(rop), ctypes.byref(root), ctypes.byref(dt), name,
        65536, shape, ctypes.byref(ndim), 32)
    if rc != 0:
        return None
    op_name, dt_name = _OP_NAMES.get(op.value), _DTYPE_NAMES.get(dt.value)
    if op_name is None or dt_name is None:
        return None     # an unknown code: a malformed or newer message
    return (rank.value, op_name, rop.value, root.value, dt_name,
            name.value.decode(), tuple(shape[i] for i in range(ndim.value)))


def encode_response(ok: bool, name: str, error: str) -> Optional[bytes]:
    lib = load()
    if lib is None:
        return None
    raw_name, raw_err = name.encode(), error.encode()
    cap = 16 + len(raw_name) + len(raw_err)
    buf = (ctypes.c_uint8 * cap)()
    n = lib.hvt_encode_response(1 if ok else 0, raw_name, raw_err, buf, cap)
    return bytes(buf[:n]) if n >= 0 else None


def decode_response(data: bytes) -> Optional[Tuple[bool, str, str]]:
    """``(ok, name, error)``, or None for bytes that are not a response."""
    lib = load()
    if lib is None:
        return None
    buf = (ctypes.c_uint8 * max(len(data), 1)).from_buffer_copy(
        data or b"\0")
    ok = ctypes.c_uint8()
    name = ctypes.create_string_buffer(65536)
    err = ctypes.create_string_buffer(65536)
    rc = lib.hvt_decode_response(buf, len(data), ctypes.byref(ok), name,
                                 65536, err, 65536)
    if rc != 0:
        return None
    return bool(ok.value), name.value.decode(), err.value.decode()


# -- controller negotiation core -------------------------------------------

class NegotiationTable:
    """Which ranks reported each pending round (the reference's
    IncrementTensorCount table): the C++ table, or a dict of sets when
    the library is disabled."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._lib = load()
        if self._lib is not None:
            self._h = self._lib.hvd_nt_new(world_size)
        else:
            self._h = None
            self._pending: dict = {}
            self._lock = threading.Lock()

    def increment(self, name: str, rank: int) -> int:
        """1 = the round just became complete (every rank in), 0 =
        pending, -1 = a duplicate or out-of-range rank."""
        if self._h is not None:
            return self._lib.hvd_nt_increment(self._h, name.encode(), rank)
        with self._lock:
            if not 0 <= rank < self.world_size:
                return -1
            ranks = self._pending.setdefault(name, set())
            if rank in ranks:
                return -1
            ranks.add(rank)
            if len(ranks) == self.world_size:
                del self._pending[name]
                return 1
            return 0

    def pending_count(self) -> int:
        """Rounds some rank reported and not every rank yet."""
        if self._h is not None:
            return int(self._lib.hvd_nt_pending(self._h))
        with self._lock:
            return len(self._pending)

    def missing_ranks(self, name: str) -> Optional[List[int]]:
        """Ranks that have not reported ``name`` yet; None when the name
        is unknown or complete."""
        if self._h is not None:
            out = (ctypes.c_uint8 * self.world_size)()
            n = self._lib.hvd_nt_missing(self._h, name.encode(), out,
                                         self.world_size)
            if n < 0:
                return None
            return [i for i in range(self.world_size) if out[i]]
        with self._lock:
            if name not in self._pending:
                return None
            got = self._pending[name]
            return [r for r in range(self.world_size) if r not in got]

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.hvd_nt_free(self._h)
            self._h = None


class ResponseCacheNative:
    """Bounded LRU of signature strings: the C++ one, or an
    ``OrderedDict`` (most recent last) when the library is disabled."""

    def __init__(self, capacity: int):
        self.capacity = max(int(capacity), 1)
        self._lib = load()
        if self._lib is not None:
            self._h = self._lib.hvd_lru_new(self.capacity)
            self._evict_buf = ctypes.create_string_buffer(65536)
        else:
            self._h = None
            self._od: "collections.OrderedDict[str, bool]" = \
                collections.OrderedDict()
            self._lock = threading.Lock()

    def lookup(self, key: str) -> bool:
        """True (and the key becomes the most recent) when cached."""
        if self._h is not None:
            return bool(self._lib.hvd_lru_lookup(self._h, key.encode()))
        with self._lock:
            if key in self._od:
                self._od.move_to_end(key)
                return True
            return False

    def put(self, key: str, want_evicted: bool = True) -> Optional[str]:
        """Insert (a present key becomes the most recent); returns the
        evicted key when capacity forced one out. ``want_evicted=False``
        skips reading it back (the hot path)."""
        if self._h is not None:
            if not want_evicted:
                self._lib.hvd_lru_put(self._h, key.encode(), None, 0)
                return None
            buf = self._evict_buf
            if self._lib.hvd_lru_put(self._h, key.encode(), buf, len(buf)):
                return buf.value.decode()
            return None
        with self._lock:
            if key in self._od:
                self._od.move_to_end(key)
                return None
            self._od[key] = True
            if len(self._od) > self.capacity:
                victim, _ = self._od.popitem(last=False)
                return victim if want_evicted else None
            return None

    def erase(self, key: str) -> None:
        if self._h is not None:
            self._lib.hvd_lru_erase(self._h, key.encode())
            return
        with self._lock:
            self._od.pop(key, None)

    def __len__(self) -> int:
        if self._h is not None:
            return int(self._lib.hvd_lru_size(self._h))
        with self._lock:
            return len(self._od)

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.hvd_lru_free(self._h)
            self._h = None


# -- GP / expected-improvement core ----------------------------------------

def gp_ei_native(x, y, candidates, length_scale: float = 1.0,
                 noise: float = 1e-4, xi: float = 0.01
                 ) -> Optional[Tuple[int, List[float]]]:
    """``(argmax index, EI per candidate)`` from the C++ GP core, or None
    when disabled, when the shapes disagree or when its Cholesky failed
    (the caller then takes the numpy path)."""
    lib = load()
    if lib is None:
        return None
    import numpy as np

    x = np.ascontiguousarray(np.atleast_2d(np.asarray(x, dtype=np.float64)))
    y = np.ascontiguousarray(np.asarray(y, dtype=np.float64))
    c = np.ascontiguousarray(np.atleast_2d(
        np.asarray(candidates, dtype=np.float64)))
    if x.shape[0] != y.shape[0] or x.shape[1] != c.shape[1]:
        return None
    n, d = x.shape
    m = c.shape[0]
    ei = np.empty(m, dtype=np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    idx = lib.hvd_gp_ei(x.ctypes.data_as(dp), y.ctypes.data_as(dp), n, d,
                        c.ctypes.data_as(dp), m, length_scale, noise, xi,
                        ei.ctypes.data_as(dp), None)
    if idx < 0:
        return None
    return int(idx), ei.tolist()


# -- timeline --------------------------------------------------------------

class NativeTimelineWriter:
    """The C++ chrome-trace writer (one per process): ``start(path)``,
    ``event(tid, name, phase, ts_us)`` with phase ``B``/``E``/``i``,
    ``stop()`` (flush and close, valid JSON) and ``dropped()`` (events
    lost to a full ring)."""

    def __init__(self):
        self._lib = load()

    @property
    def available(self) -> bool:
        return self._lib is not None

    def start(self, path: str) -> bool:
        return self._lib is not None and \
            self._lib.hvt_timeline_start(path.encode()) == 0

    def event(self, tid: str, name: str, phase: str, ts_us: float) -> None:
        self._lib.hvt_timeline_event(tid.encode(), name.encode(),
                                     phase.encode()[:1], ts_us)

    def stop(self) -> None:
        if self._lib is not None:
            self._lib.hvt_timeline_stop()

    def dropped(self) -> int:
        return int(self._lib.hvt_timeline_dropped()) if self._lib else 0
