"""The port's native host runtime (``horovod_tpu_torch/native``) against
the JAX package's (``horovod_tpu.native``): the same C++ built from the
port's own copy, so the same bytes and results.

* The copy builds under ``build/horovod_tpu_torch/native/``, never into
  the package, and a failed build raises with the compiler's output.
* Wire codec: request and response bytes identical to the JAX codec's
  for the same fields, each side decoding the other's; garbage and
  truncated frames decode to None.
* Fusion planner, negotiation table, LRU and GP/EI as in
  ``tests/test_native.py``, each held against the JAX library's answer
  and against the port's Python path (``HVD_TPU_DISABLE_NATIVE=1``);
  EI to the JAX test's rtol 1e-5, atol 1e-7.
* Timeline: the native writer's events equal the JAX writer's for the
  same calls (each library has its own writer), concurrent producers
  drop nothing, and the ``Timeline`` class writes the same trace through
  either writer.
* The controller's rounds (threads over ``InMemoryTransport``) with the
  library on, off and mixed across ranks, ``"w:"`` and ``"j:"`` frames
  counted by form.
"""

import json
import threading

import numpy as np
import pytest
import torch

from horovod_tpu import native as jnative
from horovod_tpu_torch import native
from horovod_tpu_torch.common import controller as ctl
from horovod_tpu_torch.common import fusion
from horovod_tpu_torch.common.autotune import numpy_ei
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.common.timeline import (Timeline,
                                               readiness_order_from_trace)

REQUESTS = [
    (0, "allreduce", 1, -1, "float32", "grad/w", (3, 4)),
    (3, "allgather", 0, -1, "bfloat16", "x" * 300, ()),
    (1, "broadcast", 0, 2, "int64", "bcast.é", (7,)),
    (2, "alltoall", 0, -1, "uint8", "a2a", (2, 3, 4, 5)),
    (7, "reducescatter", 1, -1, "float16", "rs", (1 << 40,)),
    (0, "barrier", 0, -1, "int32", "barrier", ()),
    (5, "join", 0, -1, "bool", "join", (1,)),
]
RESPONSES = [(True, "grad/w", ""), (False, "x", "shape mismatch: é"),
             (True, "", "")]


@pytest.fixture()
def python_paths(monkeypatch):
    monkeypatch.setenv("HVD_TPU_DISABLE_NATIVE", "1")


def test_copy_builds_outside_the_package():
    lib = native.library_path()
    assert native.load() is not None and lib.is_file()
    assert lib.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-3:] == ("build", "horovod_tpu_torch",
                                           "native")
    assert native.SOURCE_DIR == native.BUILD_DIR.parents[2] / \
        "horovod_tpu_torch" / "native"
    assert not list(native.SOURCE_DIR.glob("*.so"))
    assert sorted(p.name for p in native.SOURCE_DIR.glob("*.cc")) == \
        sorted(native.SOURCES)


def test_failed_build_raises_with_compiler_output(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-no-such-flag-hvd",))
    with pytest.raises(RuntimeError, match="no-such-flag-hvd"):
        native.load()
    monkeypatch.setattr(native, "CXX", "/nonexistent/g++")
    with pytest.raises(RuntimeError, match="native build failed"):
        native.available()


def test_disabled_takes_the_python_paths(python_paths):
    assert native.load() is None and not native.available()
    assert native.encode_request(*REQUESTS[0][:6], (1,)) is None
    assert native.plan_fusion_native([1], [0], [4], 8) is None
    assert native.gp_ei_native([[0.0]], [0.0], [[1.0]]) is None


@pytest.mark.parametrize("req", REQUESTS)
def test_request_bytes_equal_the_jax_codec(req):
    mine = native.encode_request(*req)
    theirs = jnative.encode_request(*req)
    assert mine is not None and mine == theirs
    assert native.decode_request(theirs) == req
    assert jnative.decode_request(mine) == req


@pytest.mark.parametrize("resp", RESPONSES)
def test_response_bytes_equal_the_jax_codec(resp):
    mine = native.encode_response(*resp)
    assert mine == jnative.encode_response(*resp)
    assert native.decode_response(mine) == resp
    assert jnative.decode_response(mine) == resp


def test_garbage_decodes_to_none():
    good = native.encode_request(*REQUESTS[0])
    for junk in (b"", b"\x00", b"\xff" * 40, good[:-3], good[:5],
                 native.encode_response(True, "a", "")):
        assert native.decode_request(junk) is None
        assert jnative.decode_request(junk) is None
    for junk in (b"", b"\x02", b"\x02\x01\xff\xff", good):
        assert native.decode_response(junk) is None
    # Codes outside the tables: a dtype the format does not know rides
    # JSON instead (no code 0 stands in for it).
    assert native.encode_request(0, "allreduce", 1, -1, "complex64", "c",
                                 (1,)) is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fusion_buckets_equal_jax_native_and_python(seed, monkeypatch):
    g = np.random.default_rng(seed)
    n = 200
    elems = [int(x) for x in g.integers(1, 50_000, n)]
    codes = [int(x) for x in g.integers(0, 3, n)]
    sizes = [(4, 2, 1)[c] for c in codes]
    for threshold in (0, 4096, 1 << 16, 1 << 26):
        mine = native.plan_fusion_native(elems, codes, sizes, threshold)
        assert mine == jnative.plan_fusion_native(elems, codes, sizes,
                                                  threshold)
        dtypes = [("f32", "bf16", "i8")[c] for c in codes]
        assert mine == fusion._plan_python(list(range(n)), elems, sizes,
                                           dtypes, threshold)
    leaves = [torch.zeros(int(e) % 999 + 1, dtype=(
        torch.float32, torch.bfloat16, torch.int8)[c])
        for e, c in zip(elems[:60], codes[:60])]
    for order in ("flatten", "reverse"):
        with_native = fusion.plan_fusion(leaves, 8192, order=order)
        monkeypatch.setenv("HVD_TPU_DISABLE_NATIVE", "1")
        assert fusion.plan_fusion(leaves, 8192, order=order) == with_native
        monkeypatch.delenv("HVD_TPU_DISABLE_NATIVE")


@pytest.mark.parametrize("disabled", [False, True])
def test_negotiation_table_matches_test_native(disabled, monkeypatch):
    if disabled:
        monkeypatch.setenv("HVD_TPU_DISABLE_NATIVE", "1")
    nt = native.NegotiationTable(3)
    assert (nt._h is None) == disabled
    assert nt.increment("t", 0) == 0
    assert nt.increment("t", 0) == -1           # duplicate rank
    assert nt.increment("t", 5) == -1           # out of range
    assert nt.missing_ranks("t") == [1, 2]
    assert nt.pending_count() == 1
    assert nt.increment("t", 1) == 0
    assert nt.increment("t", 2) == 1            # all in: ready, cleared
    assert nt.pending_count() == 0 and nt.missing_ranks("t") is None
    assert nt.increment("t", 0) == 0            # a new round
    bad = native.NegotiationTable(2)
    assert bad.increment("x", -1) == -1 and bad.increment("x", 7) == -1
    assert bad.pending_count() == 0 and bad.missing_ranks("x") is None
    many = native.NegotiationTable(2)
    for i in range(100):
        assert many.increment(f"g{i}", 0) == 0
    assert many.pending_count() == 100
    for i in range(100):
        assert many.increment(f"g{i}", 1) == 1
    assert many.pending_count() == 0


@pytest.mark.parametrize("disabled", [False, True])
def test_lru_matches_test_native(disabled, monkeypatch):
    if disabled:
        monkeypatch.setenv("HVD_TPU_DISABLE_NATIVE", "1")
    c = native.ResponseCacheNative(2)
    assert (c._h is None) == disabled
    assert not c.lookup("a")
    assert c.put("a") is None and c.put("b") is None
    assert c.lookup("a")                        # refresh: b is the LRU
    assert c.put("c") == "b" and len(c) == 2
    assert c.lookup("a") and c.lookup("c") and not c.lookup("b")
    c.erase("a")
    assert not c.lookup("a") and len(c) == 1
    assert c.put("a") is None                   # reinsert after erase
    assert c.put("a") is None and len(c) == 2   # repeat put: a refresh
    one = native.ResponseCacheNative(1)
    assert one.put("a", want_evicted=False) is None
    assert one.put("b", want_evicted=False) is None   # evicts a silently
    assert len(one) == 1 and one.lookup("b") and not one.lookup("a")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gp_ei_equals_jax_native_and_numpy(seed):
    g = np.random.default_rng(seed)
    xs = g.uniform(0, 4, size=(7, 2))
    ys = -((xs - 2.0) ** 2).sum(1) + g.normal(0, 0.01, 7)
    ys_n = (ys - ys.mean()) / max(ys.std(), 1e-9)
    cand = g.uniform(0, 4, size=(11, 2))
    idx, ei = native.gp_ei_native(xs, ys_n, cand)
    j_idx, j_ei = jnative.gp_ei_native(xs, ys_n, cand)
    assert idx == j_idx and ei == j_ei
    ref = numpy_ei(xs, ys_n, cand)
    np.testing.assert_allclose(ei, ref, rtol=1e-5, atol=1e-7)
    assert idx == int(np.argmax(ref))
    assert native.gp_ei_native(xs, ys_n[:3], cand) is None   # shapes


def _calls(w):
    for i in range(50):
        w.event(f"tensor_{i % 4}", "ALLREDUCE", "B", float(i * 10))
        w.event(f"tensor_{i % 4}", "", "E", float(i * 10 + 5))
    w.event("marker", "CYCLE", "i", 1000.0)


def test_timeline_events_equal_the_jax_writer(tmp_path):
    traces = []
    for mod, name in ((native, "port.json"), (jnative, "jax.json")):
        w = mod.NativeTimelineWriter()
        path = str(tmp_path / name)
        assert w.start(path)
        _calls(w)
        w.stop()
        assert w.dropped() == 0
        traces.append(json.load(open(path)))
    assert traces[0] == traces[1]
    assert len(traces[0]["traceEvents"]) == 101


def test_timeline_concurrent_producers_drop_nothing(tmp_path):
    w = native.NativeTimelineWriter()
    path = str(tmp_path / "c.json")
    before = w.dropped()
    assert w.start(path)

    def produce(tid):
        for i in range(500):
            w.event(f"t{tid}", "EV", "B", float(i))
            w.event(f"t{tid}", "", "E", float(i) + 0.5)

    threads = [threading.Thread(target=produce, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    w.stop()
    assert w.dropped() == before
    assert len(json.load(open(path))["traceEvents"]) == 4000


@pytest.mark.parametrize("disabled", [False, True])
def test_timeline_class_through_either_writer(tmp_path, monkeypatch,
                                              disabled):
    if disabled:
        monkeypatch.setenv("HVD_TPU_DISABLE_NATIVE", "1")
    path = str(tmp_path / "t.json")
    tl = Timeline(mark_cycles=True)
    tl.start(path)
    assert tl.active and tl.native == (not disabled)
    tl.begin("b", "ALLREDUCE")
    tl.begin("a", "ALLGATHER")
    tl.mark_cycle()
    tl.recovery("reset")
    tl.end("b", "ALLREDUCE")
    tl.end("a")
    tl.stop()
    assert not tl.active and tl.dropped() == 0
    events = json.load(open(path))["traceEvents"]
    assert [(e["name"], e["ph"]) for e in events] == [
        ("ALLREDUCE", "B"), ("ALLGATHER", "B"), ("CYCLE", "i"),
        ("RECOVERY:reset", "i"), ("ALLREDUCE", "E"), ("", "E")]
    assert [e["tid"] for e in events] == ["b", "a", "marker", "marker", "b",
                                          "a"]
    assert readiness_order_from_trace(path) == ["b", "a"]
    assert readiness_order_from_trace(path, "ALLGATHER") == ["a"]


def test_readiness_order_equals_jax(tmp_path):
    from horovod_tpu.common.timeline import \
        readiness_order_from_trace as jorder

    path = str(tmp_path / "t.json")
    tl = Timeline()
    tl.start(path)
    for name in ("w2", "w0", "w1", "w0"):
        tl.begin(name, "ALLREDUCE")
        tl.end(name)
    tl.stop()
    assert readiness_order_from_trace(path) == jorder(path) == \
        ["w2", "w0", "w1"]


def test_timeline_profiler_bridge_writes_a_trace(tmp_path):
    tl = Timeline()
    tl.start(str(tmp_path / "t.json"), xprof_dir=str(tmp_path / "prof"))
    torch.ones(8).sum()
    tl.stop()
    traces = list((tmp_path / "prof").glob("*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.load(open(traces[0]))


# -- the controller's frames and rounds -------------------------------------------

def _round(sizes_native, req_of, n=3):
    """One negotiation round of ``n`` ranks on threads; rank r encodes
    natively when ``sizes_native[r]``. Returns the responses."""
    transport = ctl.InMemoryTransport()
    ctls = [ctl.Controller(r, n, transport, timeout_s=10) for r in range(n)]
    out, errs = [None] * n, []
    local = threading.local()
    real = ctl._native_wire

    def wire():
        return getattr(local, "native", True) and real()

    def run(r):
        local.native = sizes_native[r]
        try:
            out[r] = ctls[r].negotiate(req_of(r))
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errs.append(e)

    ctl._native_wire = wire
    try:
        threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        ctl._native_wire = real
    return out, errs, transport


@pytest.mark.parametrize("mix", [(True, True, True), (False, False, False),
                                 (True, False, True)])
def test_controller_round_trip_on_off_mixed(mix):
    before = dict(ctl.FRAMES)
    out, errs, transport = _round(mix, lambda r: ctl.Request(
        r, "allreduce", "grad", "float32", (4, 2), 1))
    assert not errs and all(o.ok for o in out)
    assert transport._data == {}
    got = {k: ctl.FRAMES[k] - before[k] for k in before}
    # Requests: one a rank; the response: rank 0's.
    assert got["native"] == sum(mix) + int(mix[0])
    assert got["json"] == (3 - sum(mix)) + int(not mix[0])
    assert got["json_ext"] == 0


def test_controller_mismatch_and_extension_fields_ride_json():
    before = dict(ctl.FRAMES)
    out, errs, _ = _round((True, True, True), lambda r: ctl.Request(
        r, "allreduce", "g", "float32", (4,) if r != 2 else (5,), 1))
    assert len(errs) == 3 and all("ranks [2]" in str(e) for e in errs)
    out, errs, _ = _round((True, True, True), lambda r: ctl.Request(
        r, "allgather", "g2", "float32", (4,), wire_dtype="Int8"))
    assert not errs
    got = {k: ctl.FRAMES[k] - before[k] for k in before}
    # The mismatch verdict (kind, ranks) and the wire_dtype requests
    # ride JSON; the agreeing round's response rides the codec.
    assert got["json_ext"] == 1 + 3 and got["native"] == 3 + 1


def test_request_frames_decode_across_forms(monkeypatch):
    req = ctl.Request(1, "broadcast", "b", "int32", (3,), 0, 2)
    w = req.encode()
    assert w.startswith("w:") and ctl.Request.decode(w) == req
    monkeypatch.setenv("HVD_TPU_WIRE_FORMAT", "json")
    j = req.encode()
    assert j.startswith("j:") and ctl.Request.decode(j) == req
    odd = ctl.Request(1, "allreduce", "c", "complex64", (3,), 0)
    monkeypatch.delenv("HVD_TPU_WIRE_FORMAT")
    assert odd.encode().startswith("j:")
    resp = ctl.Response(True, "b")
    assert ctl.Response.decode(resp.encode()) == resp
    monkeypatch.setenv("HVD_TPU_DISABLE_NATIVE", "1")
    assert req.encode().startswith("j:")
    assert ctl.Request.decode(j) == req
    with pytest.raises(HorovodInternalError, match="HVD_TPU_WIRE_FORMAT"):
        ctl.Request.decode(w)
    with pytest.raises(HorovodInternalError, match="native wire codec"):
        ctl.Response.decode("w:" + "AAAA")


def test_autotuner_search_takes_the_native_ei():
    from horovod_tpu_torch.common.autotune import Autotuner

    tuner = Autotuner(warmup_samples=0, steps_per_sample=1)
    for i in range(6):
        tuner.feed(1 << 20, 0.01 + 0.001 * (i % 3))
    assert tuner.last_search is not None
    xs, ys, grid, ei, used_native = tuner.last_search
    assert used_native
    np.testing.assert_allclose(ei, numpy_ei(xs, ys, grid), rtol=1e-5,
                               atol=1e-7)
