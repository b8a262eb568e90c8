"""The port's eager collective engine against the JAX package's.

* Controller (one process, ranks on threads over ``InMemoryTransport``):
  the cases of ``tests/test_controller.py`` — matching requests, the
  cache fast path (no store traffic), shape/dtype/op mismatches raising
  ``MismatchError`` that names the rank, the missing-rank and
  non-coordinator timeouts, a world of one — plus ``Request.encode()``
  equal to the JAX package's JSON form and every round's keys deleted
  once read.
* ``HandleManager`` eviction and its ``KeyError`` text; a joined rank 0
  whose peer never comes raising a named error instead of hanging; the
  timeline's Chrome trace.
* Gloo ranks (each a process running this file with ``--eager-worker``,
  as ``test_torch_port_reduce.py`` does), at 2 and 4 ranks, against the
  JAX ``EagerEngine`` on a 2- and 4-device CPU mesh fed the same inputs
  stacked by rank: ``allreduce`` (SUM, AVERAGE, MIN, MAX, PRODUCT, with
  and without pre/postscale 1/3 and 0.7, fp32 and bf16), the fused
  grouped allreduce, even and ragged ``allgather``, ``broadcast``,
  ``alltoall`` on the none/bf16/int8 wires, the uneven ``alltoall`` and
  ``reducescatter``. The allreduce reference is the engine's own
  per-rank program compiled so that it rounds where the JAX code says
  (see ``_EXACT``). Tolerances: at 2 ranks every result bitwise; at 4
  ranks MIN, MAX, the gathers, the broadcast and the exchanges bitwise,
  and the sums (SUM, AVERAGE, grouped, reducescatter) within one ulp of
  the largest partial sum (PRODUCT of the largest value), since gloo
  need not combine four operands in XLA's order. The int8 wire within
  1e-6 of the largest input:
  under ``jit`` the JAX package can land a block scale an ulp from the
  IEEE quotient the port computes. Also the async handles, the signature
  cache (no store round for a repeated signature), the object
  collectives, and a mismatch raising ``MismatchError`` naming rank 1 on
  every rank, after which the next collective succeeds.
* Join (``--join-worker``): the scenarios of ``tests/test_join.py``,
  with its expected values — two processes where rank 1 joins early,
  three that join at staggered steps.

JAX is imported only in the ``J`` fixture: the worker processes import
this file and must not pay for it.
"""

import json
import sys
import threading
import types

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.common.controller import (Controller,
                                                 InMemoryTransport, Request,
                                                 Response)
from horovod_tpu_torch.common.exceptions import (HorovodInternalError,
                                                 MismatchError,
                                                 TensorShapeMismatchError)
from horovod_tpu_torch.ops import eager
from test_torch_port_worlds import run_ranks

OPS = {"sum": hvd.Sum, "average": hvd.Average, "min": hvd.Min,
       "max": hvd.Max, "product": hvd.Product}
SUMS = ("sum", "average", "product")   # order-dependent at 4 ranks
DTYPES = ("float32", "bfloat16")
PRE, POST = 1 / 3, 0.7
WIRES = ("none", "bf16", "int8")
INT8_TOL = 1e-6         # int8 alltoall vs JAX, of the largest input
GROUP_THRESHOLD = 64    # bytes: several fusion buckets for the group


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp

    from horovod_tpu.common import config as jconfig
    from horovod_tpu.common import controller as jcontroller
    from horovod_tpu.ops import eager as jeager

    return types.SimpleNamespace(jax=jax, jnp=jnp, config=jconfig,
                                 controller=jcontroller, eager=jeager)


# -- controller ---------------------------------------------------------------

def _req(rank, name="t", shape=(4,), dtype="float32", op=0):
    return Request(rank=rank, op_type="allreduce", tensor_name=name,
                   dtype=dtype, shape=tuple(shape), reduce_op=op)


def _run_ranks(n, make_req, timeout=5.0, transport=None):
    """n controller ranks on threads; returns (controllers, results,
    errors)."""
    transport = transport or InMemoryTransport()
    ctls = [Controller(r, n, transport, timeout_s=timeout) for r in range(n)]
    results, errors = [None] * n, [None] * n

    def work(r):
        try:
            results[r] = ctls[r].negotiate(make_req(r))
        except Exception as e:  # noqa: BLE001
            errors[r] = e

    threads = [threading.Thread(target=work, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout + 5)
    return ctls, results, errors


def test_matching_requests_succeed_and_leave_no_keys():
    transport = InMemoryTransport()
    ctls, results, errors = _run_ranks(4, _req, transport=transport)
    assert all(e is None for e in errors)
    assert all(r is not None and r.ok for r in results)
    assert [c.negotiation_rounds for c in ctls] == [1] * 4
    assert transport._data == {}        # every round's keys deleted


def test_cache_fast_path():
    transport = InMemoryTransport()
    ctls, _, errors = _run_ranks(2, _req, transport=transport)
    assert errors == [None, None]
    for c in ctls:
        # A repeat signature: no store traffic, no cache growth.
        c.negotiate(_req(c.rank))
        assert c.cache_size() == 1 and c.negotiation_rounds == 1
    assert transport._data == {}
    c = Controller(0, 1, transport)
    assert c.negotiate(_req(0)).ok and c.negotiation_rounds == 0


@pytest.mark.parametrize("field,bad_rank", [("shape", 2), ("dtype", 1),
                                            ("op", 3)])
def test_mismatch_names_the_rank_on_every_rank(field, bad_rank):
    def make(r):
        kw = {"shape": {"shape": (5,)}, "dtype": {"dtype": "bfloat16"},
              "op": {"op": 1}}[field] if r == bad_rank else {}
        return _req(r, **kw)

    _, _, errors = _run_ranks(4, make)
    for e in errors:
        assert isinstance(e, MismatchError)
        assert isinstance(e, TensorShapeMismatchError)
        assert e.ranks == (bad_rank,)


def test_missing_rank_times_out():
    """Rank 1 never submits: rank 0 raises the runtime-failure type
    naming it, instead of hanging."""
    c0 = Controller(0, 2, InMemoryTransport(), timeout_s=0.2)
    with pytest.raises(HorovodInternalError, match=r"ranks \[1\] did not "
                                                   "submit"):
        c0.negotiate(_req(0))


def test_non_coordinator_timeout():
    c1 = Controller(1, 2, InMemoryTransport(), timeout_s=0.2)
    with pytest.raises(HorovodInternalError, match="response timeout"):
        c1.negotiate(_req(1))


def test_exchange_gathers_in_rank_order_and_cleans_up():
    transport = InMemoryTransport()
    ctls = [Controller(r, 3, transport, timeout_s=5) for r in range(3)]
    out = [None] * 3
    threads = [threading.Thread(
        target=lambda r=r: out.__setitem__(r, ctls[r].exchange(
            "splits", json.dumps([r, r + 1])))) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert out == [[json.dumps([r, r + 1]) for r in range(3)]] * 3
    assert transport._data == {}


def test_request_encoding_matches_jax(J, monkeypatch):
    """The JSON wire form of the same fields is the JAX package's string,
    and each side decodes the other's."""
    monkeypatch.setenv("HVD_TPU_WIRE_FORMAT", "json")
    fields = dict(rank=3, op_type="alltoall", tensor_name="layer.0/kernel",
                  dtype="bfloat16", shape=(128, 256), reduce_op=1,
                  root_rank=-1, wire_dtype="int8", process_set="")
    ours, theirs = Request(**fields), J.controller.Request(**fields)
    assert ours.encode() == theirs.encode()
    assert Request.decode(theirs.encode()) == ours
    assert J.controller.Request.decode(ours.encode()) == theirs
    resp = Response(False, "t", "boom", "mismatch", (1, 2))
    assert resp.encode() == J.controller.Response(
        False, "t", "boom", "mismatch", (1, 2)).encode()
    assert Response.decode(resp.encode()) == resp


def test_signature_lru_evicts_the_least_recent():
    """The engine's signature cache: the JAX package's OrderedDict LRU."""
    from horovod_tpu_torch.native import ResponseCacheNative

    lru = ResponseCacheNative(2)
    assert lru.put("a") is None and lru.put("b") is None
    assert lru.lookup("a") and not lru.lookup("c")
    assert lru.put("c") == "b"          # "a" was touched last
    assert lru.put("a") is None and len(lru) == 2
    assert lru.put("d") == "c"


# -- handles, join timeout, timeline, contract ------------------------------

class _Done:
    def __init__(self, value, ready=True):
        self.value, self._ready, self.waited = value, ready, False

    def ready(self):
        return self._ready

    def wait(self):
        self.waited = True
        return self.value


def test_handle_manager_evicts_completed_results(monkeypatch):
    monkeypatch.setattr(eager.HandleManager, "max_retained", 4)
    hm = eager.HandleManager()
    vals = [_Done(i) for i in range(4)]
    handles = [hm.allocate(v) for v in vals]
    h = hm.allocate(_Done(99))          # evicts down to max_retained // 2
    assert [v.waited for v in vals] == [True, True, False, False]
    assert hm.poll(handles[0]) is True
    with pytest.raises(KeyError, match="evicted 2 completed-but-"
                                       "unsynchronized"):
        hm.synchronize(handles[0])
    assert hm.synchronize(handles[3]) == 3 and hm.synchronize(h) == 99
    with pytest.raises(KeyError, match="already-synchronized handle: 3"):
        hm.synchronize(handles[3])
    busy = eager.HandleManager()
    for _ in range(4):
        busy.allocate(_Done(0, ready=False))
    with pytest.raises(RuntimeError, match="in-flight"):
        busy.allocate(_Done(0))


def _fake_engine(rank, limit):
    ctl = Controller(rank, 2, InMemoryTransport(), timeout_s=0.02)
    cfg = Config(join_mode=True, stall_shutdown_time_seconds=limit)
    return eager.EagerEngine(cfg, torch.device("cpu"), rank, 2,
                             controller=ctl)


@pytest.mark.parametrize("rank,what", [(0, "rank 1's request"),
                                       (1, "rank 0's outcome")])
def test_joined_wait_times_out_with_a_named_error(rank, what):
    """A joined rank whose peer never comes raises, naming what it
    waited for, after ``stall_shutdown_time_seconds``."""
    e = _fake_engine(rank, 0.2)
    with pytest.raises(HorovodInternalError, match=f"waited 0.2s for {what} "
                                                   "of collective round 0"):
        e.join()


def test_timeline_is_a_chrome_trace(tmp_path):
    hvd.init(device="cpu")
    try:
        path = tmp_path / "trace.json"
        hvd.start_timeline(str(path), mark_cycles=True)
        x = torch.arange(6.0)
        handles = [hvd.allreduce_async(x, name=f"g{i}") for i in range(3)]
        for h in handles:
            hvd.synchronize(h)
        hvd.allgather(x, name="ag")
        hvd.stop_timeline()
        events = json.loads(path.read_text())["traceEvents"]
        names = [f"allreduce.g{i}" for i in range(3)] + ["allgather.ag"]
        for name in names:
            phases = [e["ph"] for e in events if e.get("tid") == name]
            assert phases == ["B", "E"], (name, phases)
        assert [e["name"] for e in events if e["ph"] == "B"] == \
            ["ALLREDUCE"] * 3 + ["ALLGATHER"]
        assert sum(e["name"] == "CYCLE" for e in events) == 2
    finally:
        hvd.shutdown()


def test_engine_contract_and_left_out_parts():
    """The autotuner (slice 14), the stall inspector (slice 13), the mesh
    and process-set options (slice 10) are taken; wrong splits, a wire on
    the flat uneven exchange and an object that is no process set raise
    before any exchange."""
    tuner = object()
    assert eager.EagerEngine(Config(), torch.device("cpu"), 0, 1,
                             autotuner=tuner).autotuner is tuner
    insp = object()
    assert eager.EagerEngine(Config(), torch.device("cpu"), 0, 1,
                             stall_inspector=insp).stall is insp
    mesh = (object(), object())
    e = eager.EagerEngine(Config(), torch.device("cpu"), 0, 1,
                          hier_mesh=mesh, ps_tag="ps:0,1")
    assert e.hier_mesh is mesh and e.ps_tag == "ps:0,1"
    hvd.init(device="cpu", hierarchical_allreduce=True)
    try:
        # A world of one has no (cross, local) mesh: the flat allreduce.
        assert basics.context().engine.hier_mesh is None
        x = torch.arange(8.0)
        assert torch.equal(hvd.allreduce(x, op=hvd.Sum), x)
    finally:
        hvd.shutdown()
    hvd.init(device="cpu")
    try:
        x = torch.arange(8.0)
        # The chunked exchange's self segment never touches the wire.
        assert torch.equal(hvd.alltoall(x, splits=[8], wire="int8"), x)
        assert torch.equal(hvd.alltoall(x, splits=[8], chunked=True), x)
        with pytest.raises(ValueError, match="chunked"):
            hvd.alltoall(x, splits=[8], chunked=False, wire="bf16")
        with pytest.raises(ValueError, match="auto"):
            hvd.alltoall(x, splits=[8], wire="auto")
        with pytest.raises(TensorShapeMismatchError):
            hvd.alltoall(x, splits=[7])
        with pytest.raises(TypeError, match="ProcessSet"):
            hvd.allreduce(x, process_set=object())
        assert hvd.join() == 0
        info = basics.context().engine.cache_info()
        # The two exchanges above negotiated one signature each.
        assert info["capacity"] == 1024 and info["entries"] == 2
        hvd.allreduce(x, name="a")
        hvd.allreduce(x, name="a")
        assert basics.context().engine.cache_info()["entries"] == 3
    finally:
        hvd.shutdown()


# -- gloo ranks ---------------------------------------------------------------

def _eager_data(n):
    rng = np.random.default_rng(400 + n)
    matrix = rng.integers(0, 6, (n, n))
    return {
        "ar": (rng.standard_normal((n, 37, 5)) * 3).astype(np.float32),
        "grp": [rng.standard_normal((n,) + s).astype(np.float32)
                for s in ((11,), (4, 6), (300,))],
        "ag": rng.standard_normal((n, 6, 3)).astype(np.float32),
        "agv": [rng.standard_normal(((r + 1) * 3, 4)).astype(np.float32)
                for r in range(n)],
        "a2a": rng.standard_normal((n, n * 4, 1000)).astype(np.float32),
        "matrix": matrix,
        "a2av": [rng.standard_normal((int(matrix[r].sum()), 3)).astype(
            np.float32) for r in range(n)],
        "rs": rng.standard_normal((n, n * 3, 7)).astype(np.float32),
    }


def _to(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch,
                                                                dtype))


def _np(t):
    return t.to(torch.float32).numpy() if t.is_floating_point() \
        else t.numpy()


def _eager_worker(rank: int, n: int, out_path: str) -> None:
    """One rank of an n-process gloo world (run as a script)."""
    hvd.init(device="cpu", fusion_threshold_bytes=GROUP_THRESHOLD)
    assert hvd.rank() == rank and hvd.size() == n
    d = _eager_data(n)
    ctl = basics.context().controller
    out = {}
    for dt in DTYPES:
        x = _to(d["ar"][rank], dt)
        for op, code in OPS.items():
            out[f"ar/{dt}/{op}"] = _np(hvd.allreduce(x, op=code,
                                                     name=f"ar.{dt}.{op}"))
            out[f"ar/{dt}/{op}/scaled"] = _np(hvd.allreduce(
                x, op=code, name=f"ars.{dt}.{op}", prescale_factor=PRE,
                postscale_factor=POST))
    # A repeated signature is a cache hit: no store round.
    rounds = ctl.negotiation_rounds
    h = hvd.allreduce_async(_to(d["ar"][rank], "float32"), op=hvd.Sum,
                            name="ar.float32.sum")
    out["async"] = _np(hvd.synchronize(h))
    out["async/poll"] = np.array(hvd.poll(h))
    out["rounds/repeat"] = np.array(ctl.negotiation_rounds - rounds)
    for dt in DTYPES:
        t = _to(d["ar"][rank], dt).clone()     # not a view of the data
        h = hvd.allreduce_async_(t, name=f"ar_.{dt}")
        out[f"ar_/{dt}/handle"] = np.array(type(h).__name__)
        out[f"ar_/{dt}/in_place"] = np.array(hvd.synchronize(h) is t)
        out[f"ar_/{dt}"] = _np(t)
    grp = [_to(g[rank], "float32") for g in d["grp"]]
    for label, kw in (("sum", {"op": hvd.Sum, "prescale_factor": PRE,
                               "postscale_factor": POST}),
                      ("average", {})):
        for i, y in enumerate(hvd.grouped_allreduce(grp, name=f"grp.{label}",
                                                    **kw)):
            out[f"grp/{label}/{i}"] = _np(y)
    out["ag"] = _np(hvd.allgather(_to(d["ag"][rank], "float32"), name="ag"))
    out["agv"] = _np(hvd.allgatherv(_to(d["agv"][rank], "float32"),
                                    name="agv"))
    out["bc"] = _np(hvd.broadcast(_to(d["ag"][rank], "float32"),
                                  root_rank=n - 1, name="bc"))
    for wire in WIRES:
        out[f"a2a/{wire}"] = _np(hvd.alltoall(_to(d["a2a"][rank],
                                                  "float32"),
                                              name=f"a2a.{wire}", wire=wire))
    out["a2av"] = _np(hvd.alltoall(_to(d["a2av"][rank], "float32"),
                                   name="a2av",
                                   splits=d["matrix"][rank].tolist()))
    for op in ("sum", "average"):
        out[f"rs/{op}"] = _np(hvd.reducescatter(_to(d["rs"][rank],
                                                    "float32"),
                                                op=OPS[op], name=f"rs.{op}"))
    out["obj/bcast"] = np.array(json.dumps(hvd.broadcast_object(
        {"rank": rank, "lr": 0.1 * (rank + 1)}, root_rank=1)))
    out["obj/gather"] = np.array(hvd.allgather_object(rank * 10))
    try:
        hvd.allreduce(torch.ones(4 + (rank == 1)), name="probe")
        out["mm/type"] = np.array("none")
    except MismatchError as e:
        out["mm/type"] = np.array(type(e).__name__)
        out["mm/ranks"] = np.array(e.ranks)
    out["mm/next"] = _np(hvd.allreduce(torch.ones(3), op=hvd.Sum,
                                       name="after"))
    hvd.shutdown()
    np.savez(out_path, **out)


def _join_worker(scenario: str, rank: int, n: int, out_path: str) -> None:
    """The join scenarios of tests/test_join.py (run as a script)."""
    hvd.init(device="cpu", join_mode=True)
    assert hvd.size() == n

    def val(y):
        return float(y[0])

    log = []
    if scenario == "two":
        for i in range(2):
            log.append(val(hvd.allreduce(torch.full((3,), rank + 1.0),
                                         name=f"step{i}")))
        if rank == 0:
            for i in range(2, 4):
                log.append(val(hvd.allreduce(torch.full((3,), 7.0),
                                             name=f"step{i}")))
    else:
        for i in range({0: 4, 1: 1, 2: 2}[rank]):
            log.append(val(hvd.allreduce(torch.full((2,), rank + 1.0),
                                         name=f"s{i}")))
    last = hvd.join()
    hvd.shutdown()
    np.savez(out_path, log=np.array(log), last=np.array(last))


def _run_world(args, n, out):
    run_ranks(__file__, lambda r: (*args, r, n, out / f"rank{r}.npz"), n)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(n)]


_WORLDS = {}


def _world(key, args, n, tmp_path_factory):
    if key not in _WORLDS:
        _WORLDS[key] = _run_world(args, n, tmp_path_factory.mktemp(key))
    return _WORLDS[key]


@pytest.fixture(params=[2, 4], ids=["n2", "n4"])
def world(request, tmp_path_factory):
    n = request.param
    return n, _world(f"eager{n}", ["--eager-worker"], n, tmp_path_factory)


_JAX_ENGINES = {}


def _jax_engine(J, n):
    """The JAX package's EagerEngine on an n-device CPU mesh."""
    if n not in _JAX_ENGINES:
        from jax.sharding import Mesh

        mesh = Mesh(np.array(J.jax.devices()[:n]), ("hvd",))
        cfg = J.config.Config()
        cfg.fusion_threshold_bytes = GROUP_THRESHOLD
        _JAX_ENGINES[n] = J.eager.EagerEngine(mesh, "hvd", cfg)
    return _JAX_ENGINES[n]


def _jnp(J, x, dtype="float32"):
    return J.jnp.asarray(x, getattr(J.jnp, dtype))


def _rows(out):
    """A JAX engine's rank-major result as float32 numpy rows."""
    return np.asarray(out.astype(np.float32) if hasattr(out, "astype")
                      else out, np.float32)


def _ulp(v, dtype):
    """One ulp of max |v| in ``dtype``."""
    v = np.float32(np.abs(v).max())
    if dtype == "bfloat16":
        return np.float32(2.0 ** (np.floor(np.log2(v)) - 7))
    return np.spacing(v)


def _assert_close(got, want, n, exact, dtype, what, largest=None):
    """Bitwise at 2 ranks (or when ``exact``); else within one ulp of the
    largest value the sum passes through (``largest``, default the
    result's)."""
    if n == 2 or exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        tol = _ulp(want if largest is None else largest, dtype)
        assert np.abs(got - want).max() <= tol, (what, np.abs(
            got - want).max(), tol)


# The reference programs are compiled so that they round where the JAX
# code says: by default XLA's CPU compiler promotes a bf16 all-reduce to
# fp32 and, allowed excess precision, feeds it the prescaled operand
# unrounded — one bf16 ulp off the written arithmetic on about a fifth of
# the elements. The port reduces in the tensor's dtype, as Horovod does.
_EXACT = {"xla_allow_excess_precision": False}


def _jax_allreduce(J, n, x, op, kw):
    """The JAX EagerEngine's per-rank allreduce program on an n-device
    mesh, fed ``x`` stacked by rank."""
    e = _jax_engine(J, n)
    f = e._shard_mapped(lambda v: J.eager.C.allreduce(v, op, "hvd", **kw))
    dt = e.scatter(x)
    return _rows(f.lower(dt).compile(compiler_options=_EXACT)(dt))


@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "scaled"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", list(OPS))
def test_allreduce_matches_jax(J, world, op, dtype, scaled):
    n, ranks = world
    kw = {"prescale_factor": PRE, "postscale_factor": POST} if scaled else {}
    jop = J.eager.C.ReduceOp[op.upper()]
    x = _jnp(J, _eager_data(n)["ar"], dtype)
    want = _jax_allreduce(J, n, x, jop, kw)
    # The largest partial sum, in the result's units.
    largest = np.abs(np.asarray(x.astype(np.float32))).sum(0) * (
        PRE * POST if scaled else 1.0) / (n if op == "average" else 1)
    key = f"ar/{dtype}/{op}" + ("/scaled" if scaled else "")
    for r in range(n):
        _assert_close(ranks[r][key], want[r], n, op not in SUMS, dtype,
                      f"{key} rank {r}",
                      largest if op in ("sum", "average") else None)
        np.testing.assert_array_equal(ranks[r][key], ranks[0][key])


def test_async_handles_and_the_signature_cache(world):
    n, ranks = world
    for r in range(n):
        np.testing.assert_array_equal(ranks[r]["async"],
                                      ranks[r]["ar/float32/sum"])
        assert ranks[r]["async/poll"] and ranks[r]["rounds/repeat"] == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_allreduce_async_inplace_averages_into_the_tensor(world, dtype):
    """Horovod's ``allreduce_async_(t, name=...)`` (the JAX package's
    PyTorch surface, ``horovod_tpu/torch/__init__.py``): an int handle,
    and ``synchronize`` writes the average into ``t`` and returns ``t``,
    bitwise the result of ``allreduce(t, op=Average)``."""
    n, ranks = world
    for r in range(n):
        assert ranks[r][f"ar_/{dtype}/handle"] == "int"
        assert ranks[r][f"ar_/{dtype}/in_place"]
        np.testing.assert_array_equal(ranks[r][f"ar_/{dtype}"],
                                      ranks[r][f"ar/{dtype}/average"])


@pytest.mark.parametrize("label", ["sum", "average"])
def test_grouped_allreduce_matches_jax(J, world, label):
    n, ranks = world
    e = _jax_engine(J, n)
    kw = ({"op": J.eager.C.ReduceOp.SUM, "prescale_factor": PRE,
           "postscale_factor": POST} if label == "sum" else {})
    grp = _eager_data(n)["grp"]
    want = e.allreduce_tree([_jnp(J, g) for g in grp], **kw)
    for i, w in enumerate(want):
        largest = np.abs(grp[i]).sum(0) * (PRE * POST if label == "sum"
                                           else 1 / n)
        for r in range(n):
            _assert_close(ranks[r][f"grp/{label}/{i}"], _rows(w)[r], n,
                          False, "float32", f"grp {label} {i} rank {r}",
                          largest)


def test_gathers_and_broadcast_match_jax(J, world):
    n, ranks = world
    d = _eager_data(n)
    e = _jax_engine(J, n)
    ag = _rows(e.allgather(_jnp(J, d["ag"])))
    agv = _rows(e.allgather([_jnp(J, v) for v in d["agv"]]))
    bc = _rows(e.broadcast(_jnp(J, d["ag"]), n - 1))
    for r in range(n):
        np.testing.assert_array_equal(ranks[r]["ag"], ag[r])
        np.testing.assert_array_equal(ranks[r]["agv"], agv[r])
        np.testing.assert_array_equal(ranks[r]["bc"], bc[r])


@pytest.mark.parametrize("wire", WIRES)
def test_alltoall_matches_jax(J, world, wire):
    n, ranks = world
    d = _eager_data(n)
    want = _rows(_jax_engine(J, n).alltoall(_jnp(J, d["a2a"]), wire=wire))
    for r in range(n):
        got = ranks[r][f"a2a/{wire}"]
        if wire == "int8":
            np.testing.assert_allclose(
                got, want[r], rtol=0,
                atol=INT8_TOL * np.abs(d["a2a"]).max())
        else:
            np.testing.assert_array_equal(got, want[r])


def test_uneven_alltoall_matches_jax(J, world):
    n, ranks = world
    d = _eager_data(n)
    want = _jax_engine(J, n).alltoallv(d["a2av"], d["matrix"].tolist())
    for r in range(n):
        np.testing.assert_array_equal(ranks[r]["a2av"], want[r])


@pytest.mark.parametrize("op", ["sum", "average"])
def test_reducescatter_matches_jax(J, world, op):
    n, ranks = world
    jop = J.eager.C.ReduceOp[op.upper()]
    x = _eager_data(n)["rs"]
    want = _rows(_jax_engine(J, n).reducescatter(_jnp(J, x), jop))
    largest = np.abs(x).sum(0) / (n if op == "average" else 1)
    for r in range(n):
        _assert_close(ranks[r][f"rs/{op}"], want[r], n, False, "float32",
                      f"rs {op} rank {r}", largest)


def test_object_collectives(world):
    n, ranks = world
    for r in range(n):
        assert json.loads(str(ranks[r]["obj/bcast"])) == {"rank": 1,
                                                          "lr": 0.2}
        assert ranks[r]["obj/gather"].tolist() == [10 * k for k in range(n)]


def test_mismatch_raises_on_every_rank_then_recovers(world):
    n, ranks = world
    for r in range(n):
        assert str(ranks[r]["mm/type"]) == "MismatchError"
        assert ranks[r]["mm/ranks"].tolist() == [1]
        np.testing.assert_array_equal(ranks[r]["mm/next"], np.full(3, n))


def test_join_two_process_early_exit(tmp_path_factory):
    """Rank 1 joins after two steps; rank 0's averages then divide by the
    one active rank, and both learn that rank 0 joined last."""
    r0, r1 = _world("join2", ["--join-worker", "two"], 2, tmp_path_factory)
    assert r0["log"].tolist() == [1.5, 1.5, 7.0, 7.0]
    assert r1["log"].tolist() == [1.5, 1.5]
    assert int(r0["last"]) == 0 and int(r1["last"]) == 0


def test_join_three_process_staggered(tmp_path_factory):
    ranks = _world("join3", ["--join-worker", "three"], 3, tmp_path_factory)
    assert ranks[0]["log"].tolist() == [2.0, 2.0, 1.0, 1.0]
    assert ranks[1]["log"].tolist() == [2.0]
    assert ranks[2]["log"].tolist() == [2.0, 2.0]
    assert all(int(rk["last"]) == 0 for rk in ranks)


if __name__ == "__main__" and sys.argv[1:2] == ["--eager-worker"]:
    _eager_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
if __name__ == "__main__" and sys.argv[1:2] == ["--join-worker"]:
    _join_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                 sys.argv[5])
