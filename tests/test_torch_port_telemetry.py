"""The port's telemetry (``horovod_tpu_torch/common/``: ``metrics.py``,
``lockdep.py``, ``shutdown.py``, ``affinity.py``, ``stall.py``,
``flightrec.py``, ``podmon.py``) against the JAX package's modules of
the same names, after the reference tests ``tests/test_metrics.py``,
``test_stall.py``, ``test_flightrec.py``, ``test_podmon.py`` and
``test_affinity.py``.

* metrics: the same operations give byte-equal Prometheus text and
  equal snapshots in both registries; the dump file, ``/metrics`` and
  ``/metrics.json`` serve that snapshot; ``/debug/stacks`` names the main
  thread; a second ``/debug/profile`` during a capture gets a 503.
* lockdep, shutdown and affinity give the JAX modules' results.
* stall: under one injected clock both inspectors give the same
  in-flight tables, warnings and fatal latch; a world of 2 with a
  ``collective_stall`` on one rank's ``allreduce_async`` warns, marks
  the event stalled and, past the shutdown time, raises
  ``StallTimeoutError`` with a black box written.
* flightrec: the black-box schema is the JAX package's and
  ``tools/flight_diff.py``'s; a port box passes the validator; the
  trigger map agrees; a gloo allreduce loop under ``HVD_TPU_LOCKDEP=
  raise`` takes 20 SIGUSR2s without a deadlock or a lock cycle.
* podmon: recorded snapshots fed to both monitors give equal merged
  views, Prometheus text and step reports.
"""

import dataclasses
import importlib.util
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from horovod_tpu_torch.common import affinity as P_affinity
from horovod_tpu_torch.common import exceptions as P_exc
from horovod_tpu_torch.common import flightrec as P_flightrec
from horovod_tpu_torch.common import lockdep as P_lockdep
from horovod_tpu_torch.common import metrics as P_metrics
from horovod_tpu_torch.common import podmon as P_podmon
from horovod_tpu_torch.common import shutdown as P_shutdown
from horovod_tpu_torch.common import stall as P_stall
from test_torch_port_worlds import REPO, rank_env, run_ranks

STALL_CHECK_S, STALL_SHUTDOWN_S, STALL_DELAY_S = 0.4, 1.2, 2.5
SIGNALS = 20


@pytest.fixture(scope="module")
def J():
    from horovod_tpu.common import affinity, exceptions, flightrec, \
        lockdep, metrics, podmon, shutdown, stall

    return types.SimpleNamespace(
        affinity=affinity, exc=exceptions, flightrec=flightrec,
        lockdep=lockdep, metrics=metrics, podmon=podmon, shutdown=shutdown,
        stall=stall)


def _flight_diff():
    spec = importlib.util.spec_from_file_location(
        "flight_diff", REPO / "tools" / "flight_diff.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- metrics -------------------------------------------------------------------

def _ops_basic(reg):
    c = reg.counter("hvd_tpu_test_ops_total", "ops by kind", ("kind",))
    c.labels(kind="a").inc()
    c.labels(kind="b").inc(2.5)
    g = reg.gauge("hvd_tpu_test_depth", "queue depth")
    g.set(7)
    g.dec(2)
    h = reg.histogram("hvd_tpu_test_seconds", "latency", ("op",),
                      buckets=(0.001, 0.01, 0.1, 1.0))
    for v in (0.0005, 0.02, 0.5, 3.0, 0.01):
        h.labels(op="allreduce").observe(v)


def _ops_odd_values(reg):
    g = reg.gauge("hvd_tpu_test_norm", "a norm that may diverge", ("x",))
    g.labels(x="inf").set(math.inf)
    g.labels(x="-inf").set(-math.inf)
    g.labels(x="nan").set(math.nan)
    g.labels(x="big").set(1e17)
    g.labels(x="frac").set(1 / 3)
    c = reg.counter("hvd_tpu_test_escape_total", 'help with "quotes"\n'
                    "and a newline", ("name",))
    c.labels(name='a"b\\c\nd').inc()
    reg.histogram("hvd_tpu_test_unlabeled_seconds", "").observe(0.25)


def _ops_global_labels(reg):
    reg.set_global_labels(rank="3", size="4", host="hostC")
    _ops_basic(reg)
    reg.counter("hvd_tpu_test_untouched_total", "never fired")


@pytest.mark.parametrize("ops", [_ops_basic, _ops_odd_values,
                                 _ops_global_labels],
                         ids=["basic", "odd_values", "global_labels"])
def test_prometheus_text_and_snapshot_match_jax(J, ops):
    jreg = J.metrics.MetricsRegistry(enabled=True)
    preg = P_metrics.MetricsRegistry(enabled=True)
    ops(jreg)
    ops(preg)
    assert preg.prometheus_text() == jreg.prometheus_text()
    assert json.dumps(preg.snapshot(), sort_keys=True) == \
        json.dumps(jreg.snapshot(), sort_keys=True)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_dump_file_and_server_serve_the_snapshot(tmp_path):
    reg = P_metrics.MetricsRegistry(enabled=True)
    _ops_global_labels(reg)
    dumper = P_metrics.MetricsDumper(str(tmp_path / "m.jsonl"),
                                     interval_s=0.05, reg=reg).start()
    time.sleep(0.2)
    dumper.stop()
    lines = [json.loads(x) for x in (tmp_path / "m.jsonl").read_text()
             .splitlines()]
    assert len(lines) >= 2
    assert all(line["metrics"] == json.loads(json.dumps(reg.snapshot()))
               for line in lines)
    srv = P_metrics.MetricsServer(reg=reg, host="127.0.0.1")
    port = srv.start(0, debug=True)
    try:
        code, body = _get(f"http://127.0.0.1:{port}/metrics")
        assert code == 200 and body == reg.prometheus_text()
        code, body = _get(f"http://127.0.0.1:{port}/metrics.json")
        assert code == 200 and json.loads(body) == \
            json.loads(json.dumps(reg.snapshot()))
        code, body = _get(f"http://127.0.0.1:{port}/debug/stacks")
        assert code == 200 and "--- thread MainThread" in body
    finally:
        srv.stop()


def test_debug_profile_is_one_capture_at_a_time(tmp_path):
    reg = P_metrics.MetricsRegistry(enabled=True)
    srv = P_metrics.MetricsServer(reg=reg, host="127.0.0.1")
    port = srv.start(0, debug=True)
    first = {}

    def capture():
        first["code"], first["body"] = _get(
            f"http://127.0.0.1:{port}/debug/profile?ms=1500&dir={tmp_path}")

    try:
        t = threading.Thread(target=capture)
        t.start()
        deadline = time.monotonic() + 10
        while not P_metrics._profile_lock.locked() and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        code, body = _get(f"http://127.0.0.1:{port}/debug/profile?ms=10")
        assert code == 503 and "already in progress" in body
        t.join(60)
        assert not t.is_alive()
        assert first["code"] == 200, first["body"][-2000:]
        payload = json.loads(first["body"])
        assert payload["dir"] == str(tmp_path) and payload["ms"] == 1500
        assert os.path.exists(payload["file"])
        assert "traceEvents" in payload["trace"]
    finally:
        srv.stop()


def test_trace_bridge_opens_record_function_ranges(monkeypatch):
    """With the switch on, and with it off while a profiler records, a
    histogram's timer opens its range; with the switch off and no
    profiler it opens none."""
    import torch

    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    for switch in (True, False):
        reg = P_metrics.MetricsRegistry(enabled=True, trace_bridge=switch)
        monkeypatch.setattr(P_metrics, "_registry", reg)
        h = reg.histogram("hvd_tpu_test_phase_seconds", "", ("phase",))
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with h.labels(phase="comm").time(annotation="hvd_step/comm"):
                torch.ones(8).sum()
        names = {e.key for e in prof.key_averages()}
        assert "hvd_step/comm" in names, switch
        assert reg.snapshot()["hvd_tpu_test_phase_seconds"]["samples"][0][
            "value"]["count"] == 1
    del opened[:]
    with h.labels(phase="comm").time(annotation="hvd_step/comm"):
        torch.ones(8).sum()
    assert opened == []
    assert reg.snapshot()["hvd_tpu_test_phase_seconds"]["samples"][0][
        "value"]["count"] == 2


def test_init_stamps_labels_and_falls_back_to_an_ephemeral_port(
        monkeypatch):
    import socket

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics

    monkeypatch.setenv("HVD_TPU_HOSTNAME", "hostQ")
    taken = socket.socket()
    taken.bind(("0.0.0.0", 0))
    taken.listen(1)
    busy = taken.getsockname()[1]
    try:
        hvd.init(device="cpu", metrics_port=busy)
        try:
            port = basics.context().metrics_port
            assert port is not None and port != busy
            assert hvd.start_metrics_server(0) == port
            code, body = _get(f"http://127.0.0.1:{port}/metrics")
            assert code == 200
            assert 'host="hostQ",' in body and 'rank="0"' in body \
                and 'size="1"' in body
            samples = hvd.metrics()["hvd_tpu_stall_inflight"]["samples"]
            assert samples[0]["labels"] == {"rank": "0", "size": "1",
                                            "host": "hostQ"}
        finally:
            hvd.shutdown()
        assert P_metrics.serving_port() is None
    finally:
        taken.close()
        P_metrics.registry()._global_labels.pop("host", None)


def test_disabled_registry_is_the_noop_singleton():
    reg = P_metrics.MetricsRegistry(enabled=False)
    assert reg.counter("hvd_tpu_x_total") is P_metrics.NOOP
    assert reg.histogram("hvd_tpu_x_seconds").labels(op="a").time() is \
        P_metrics._NOOP_TIMER
    assert reg.snapshot() == {} and reg.prometheus_text() == "\n"


# -- lockdep, shutdown, affinity -----------------------------------------------

def _acquire_script(mod):
    """One nesting script run against a lockdep module: a -> b, b -> c
    on threads, and the reverse c -> a closing a cycle on the main
    thread (record mode: logged and kept)."""
    a, b, c = mod.lock("t.a"), mod.lock("t.b"), mod.lock("t.c")

    def nest(x, y):
        with x:
            with y:
                pass

    for x, y in ((a, b), (b, c)):
        t = threading.Thread(target=nest, args=(x, y))
        t.start()
        t.join(10)
    nest(a, c)
    nest(c, a)
    return mod.edges(), mod.cycles()


def test_lockdep_edges_and_cycles_match_jax(J):
    got = {}
    for name, mod in (("jax", J.lockdep), ("port", P_lockdep)):
        mod.install("record")
        try:
            got[name] = _acquire_script(mod)
        finally:
            mod._reset_for_tests()
    assert got["port"] == got["jax"]
    assert got["port"][1] == [("t.a", "t.b", "t.c")]
    P_lockdep.install("raise")
    try:
        a, b = P_lockdep.lock("r.a"), P_lockdep.lock("r.b")
        with a:
            with b:
                pass
        with b:
            with pytest.raises(P_lockdep.LockCycleError, match="r.a"):
                a.acquire()
        assert not a.locked()
    finally:
        P_lockdep._reset_for_tests()
    assert not isinstance(P_lockdep.lock("plain"), P_lockdep.TrackedLock)


@pytest.fixture()
def fresh_shutdown(J):
    """Both shutdown registries empty for the test; the process's own
    registrations restored after it."""
    saved = {m: dict(m._callbacks) for m in (P_shutdown, J.shutdown)}
    for m in saved:
        m._reset_for_tests()
    yield
    for m, cbs in saved.items():
        m._reset_for_tests()
        m._callbacks.update(cbs)


def test_shutdown_runs_in_priority_order_once(J, fresh_shutdown):
    orders = {}
    for name, mod in (("jax", J.shutdown), ("port", P_shutdown)):
        order = orders.setdefault(name, [])
        for cb, prio in (("stats", mod.RECOVERY_STATS_PRIORITY),
                         ("late", 90), ("flightrec", mod.FLIGHTREC_PRIORITY),
                         ("context", mod.CONTEXT_PRIORITY)):
            mod.register(cb, lambda cb=cb: order.append(cb), prio)
        mod.register("boom", lambda: 1 / 0, 15)    # isolated
        mod.register("late", lambda: order.append("late2"), 90)
        mod.run()
        mod.run()
    assert orders["port"] == orders["jax"] == \
        ["flightrec", "context", "stats", "late2"]


@pytest.mark.parametrize("spec,local_size", [
    ("0,4, 8 ,12", 4), ("0,x,2", 3), ("0,-1,2", 3), ("0,1", 4),
    ("3,2,1,0", 2), ("", 1), ("7,", 1)])
def test_parse_affinity_matches_jax(J, spec, local_size):
    assert P_affinity.parse_affinity(spec, local_size) == \
        J.affinity.parse_affinity(spec, local_size)


def test_affinity_is_applied_at_init_and_bad_specs_change_nothing(
        monkeypatch):
    import horovod_tpu_torch as hvd

    before = os.sched_getaffinity(0)
    core = sorted(before)[0]
    monkeypatch.setenv("HVD_TPU_THREAD_AFFINITY", "x,y")
    hvd.init(device="cpu")
    try:
        assert os.sched_getaffinity(0) == before
    finally:
        hvd.shutdown()
    try:
        hvd.init(device="cpu", thread_affinity=str(core))
        try:
            assert os.sched_getaffinity(0) == {core}
        finally:
            hvd.shutdown()
    finally:
        os.sched_setaffinity(0, before)


# -- stall ---------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _warnings(mod):
    return mod.metrics.snapshot().get("hvd_tpu_stall_warnings_total", {}) \
        .get("samples", [{"value": 0}])[0]["value"]


@pytest.fixture()
def boxes_in(tmp_path, J):
    """Both packages' flight recorders writing into ``tmp_path``."""
    jold, pold = J.flightrec._recorder, P_flightrec._recorder
    J.flightrec.install(J.flightrec.FlightRecorder(
        directory=str(tmp_path / "jax"), rank=0))
    P_flightrec.install(P_flightrec.FlightRecorder(
        directory=str(tmp_path / "port"), rank=0))
    yield tmp_path
    J.flightrec._recorder, P_flightrec._recorder = jold, pold


@pytest.mark.parametrize("fatal_mode", [None, "raise"])
def test_stall_inspectors_agree_under_one_clock(J, monkeypatch, boxes_in,
                                                fatal_mode):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    insp = {"jax": J.stall.StallInspector(5.0, 20.0,
                                          fatal_mode=fatal_mode),
            "port": P_stall.StallInspector(5.0, 20.0,
                                           fatal_mode=fatal_mode)}
    mods = {"jax": types.SimpleNamespace(metrics=J.metrics),
            "port": types.SimpleNamespace(metrics=P_metrics)}
    w0 = {k: _warnings(m) for k, m in mods.items()}
    trace = {k: [] for k in insp}
    script = [("submit", "allreduce.a"), ("tick", 1.0),
              ("submit", "allreduce.b"), ("tick", 3.0), ("check",),
              ("complete", "allreduce.b"), ("tick", 2.5), ("check",),
              ("tick", 1.0), ("check",), ("submit", "allreduce.c"),
              ("tick", 12.0), ("check",)]
    for op in script:
        if op[0] == "tick":
            clock.t += op[1]
            continue
        for k, i in insp.items():
            if op[0] == "submit":
                i.record_submit(op[1])
            elif op[0] == "complete":
                i.record_complete(op[1])
            else:
                trace[k].append(i.check())
            trace[k].append(sorted(
                (n, round(clock.t - t0, 6)) for n, t0 in
                i.inflight().items()))
    assert trace["port"] == trace["jax"]
    assert {k: _warnings(m) - w0[k] for k, m in mods.items()} == \
        {"jax": 2, "port": 2}
    exc = {"jax": (J.exc.StallTimeoutError if fatal_mode else
                   J.exc.StallError),
           "port": (P_exc.StallTimeoutError if fatal_mode else
                    P_exc.StallError)}
    clock.t += 4.0
    for k, i in insp.items():
        with pytest.raises(exc[k], match="allreduce.a stalled for 24s"):
            i.check()
    assert issubclass(P_exc.StallTimeoutError, P_exc.HorovodInternalError)
    box = json.loads((boxes_in / "port" / "blackbox.rank0.json")
                     .read_text())
    assert box["trigger"] == "stall_timeout"


def _stall_worker(rank: int, out: str) -> None:
    """One rank of the stall world: rank 1's second allreduce is held
    (the ``collective_stall`` site) past the check and shutdown times."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import metrics

    hvd.init(device="cpu")
    x = torch.arange(4.0)
    res = {}
    hvd.synchronize(hvd.allreduce_async(x, name="g0"))
    h = hvd.allreduce_async(x, name="g1")
    res["g1"] = hvd.synchronize(h).tolist()
    if rank == 1:
        snap = metrics.snapshot()
        res["warnings"] = snap["hvd_tpu_stall_warnings_total"][
            "samples"][0]["value"]
        box_path = hvd.flight_recorder().box_path()
        with open(box_path) as f:
            res["box"] = json.load(f)
        try:
            hvd.allreduce_async(x, name="g2")
            res["raised"] = None
        except hvd.StallTimeoutError as e:
            res["raised"] = str(e)
    with open(out, "w") as f:
        json.dump(res, f)
    os._exit(0)


def test_collective_stall_warns_then_is_fatal(tmp_path):
    """A world of 2: rank 1 hangs inside its second allreduce (issued,
    not completed). Its inspector warns past the check time and marks
    the ring's event ``stalled``; past the shutdown time it latches a
    StallTimeoutError (``HVD_TPU_STALL_FATAL=raise``), writes the black
    box, and the next submit raises."""
    plan = {"seed": 0, "faults": [{"site": "collective_stall", "step": 2,
                                   "rank": 1, "delay_s": STALL_DELAY_S}]}
    run_ranks(__file__, lambda r: ["--stall-worker", r,
                                   tmp_path / f"out{r}.json"], 2,
              timeout=120,
              HVD_TPU_FAULT_PLAN=json.dumps(plan),
              HVD_TPU_STALL_CHECK_TIME_SECONDS=str(STALL_CHECK_S),
              HVD_TPU_STALL_SHUTDOWN_TIME_SECONDS=str(STALL_SHUTDOWN_S),
              HVD_TPU_STALL_FATAL="raise",
              HVD_TPU_FLIGHTREC_DIR=str(tmp_path / "boxes"))
    r0 = json.loads((tmp_path / "out0.json").read_text())
    r1 = json.loads((tmp_path / "out1.json").read_text())
    assert r0["g1"] == r1["g1"] == [0.0, 1.0, 2.0, 3.0]    # the average
    assert r1["warnings"] >= 1
    box = r1["box"]
    assert box["trigger"] == "stall_timeout"
    assert "StallTimeoutError" in box["reason"]
    stalled = [e for e in box["events"] if e["name"] == "allreduce.g1"]
    assert stalled and stalled[0]["outcome"] == "stalled"
    assert "allreduce.g1" in box["stall_inflight"]
    assert r1["raised"] and "allreduce.g1 stalled" in r1["raised"]
    _flight_diff().load_blackbox(
        str(tmp_path / "boxes" / "blackbox.rank1.json"))


# -- flight recorder -----------------------------------------------------------

def test_blackbox_schema_is_jax_and_flight_diffs(J):
    fd = _flight_diff()
    assert P_flightrec.BLACKBOX_KEYS == J.flightrec.BLACKBOX_KEYS == \
        fd.BLACKBOX_KEYS
    assert P_flightrec.EVENT_KEYS == J.flightrec.EVENT_KEYS == \
        fd.EVENT_KEYS
    assert P_flightrec.BLACKBOX_SCHEMA_VERSION == \
        J.flightrec.BLACKBOX_SCHEMA_VERSION == fd.BLACKBOX_SCHEMA_VERSION


def test_port_blackbox_passes_flight_diff(tmp_path, monkeypatch):
    monkeypatch.delenv("HVD_TPU_PROC_ID", raising=False)
    fd = _flight_diff()
    boxes = {}
    for rank in (0, 1):
        rec = P_flightrec.FlightRecorder(directory=str(tmp_path), rank=rank,
                                         host=f"host{rank}")
        insp = P_stall.StallInspector(60.0)
        rec._stall_inspector = insp
        for i in range(3):
            rec.record_submit(f"allreduce.g{i}", "allreduce")
            rec.annotate(f"allreduce.g{i}", nbytes=16, wire="none")
            insp.record_submit(f"allreduce.g{i}")
            if not (rank == 1 and i == 2):
                rec.record_complete(f"allreduce.g{i}")
                insp.record_complete(f"allreduce.g{i}")
        rec.advance_step()
        path = rec.dump("manual", reason="test")
        boxes[rank] = fd.load_blackbox(path)
    assert boxes[1]["stall_inflight"].keys() == {"allreduce.g2"}
    report = fd.analyze(boxes)
    assert report["laggard_rank"] == 1
    assert report["findings"][0]["incomplete_ranks"] == [1]


@pytest.mark.parametrize("kind", ["StallTimeoutError", "StallError",
                                  "MismatchError", "NonFiniteError",
                                  "HorovodInternalError",
                                  "TensorShapeMismatchError"])
def test_dump_trigger_map_matches_jax(J, kind):
    def make(mod):
        cls = getattr(mod, kind)
        return cls("x") if kind != "MismatchError" else cls("x", ranks=(1,))

    assert P_flightrec._trigger_for(make(P_exc)) == \
        J.flightrec._trigger_for(make(J.exc))
    assert P_flightrec._trigger_for(ValueError("x")) is None


def _sigusr2_worker(out: str) -> None:
    """A gloo allreduce loop under ``HVD_TPU_LOCKDEP=raise`` that takes
    SIGUSR2s while it runs: each one must write a box (the handler hands
    the dump to a thread), none may deadlock or close a lock cycle."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import lockdep, metrics

    hvd.init(device="cpu")
    x = torch.ones(1024)
    with open(out + ".ready", "w") as f:
        f.write(str(os.getpid()))
    i = 0
    stop = out + ".stop"
    while not os.path.exists(stop):
        hvd.allreduce(x, name=f"loop{i % 7}")
        i += 1
    deadline = time.monotonic() + 20
    dumps = 0
    while time.monotonic() < deadline:
        dumps = [s["value"] for s in metrics.snapshot()[
            "hvd_tpu_flightrec_dumps_total"]["samples"]
                 if s["labels"]["trigger"] == "sigusr2"][0]
        if dumps >= SIGNALS:
            break
        time.sleep(0.05)
    with open(hvd.flight_recorder().box_path()) as f:
        box = json.load(f)
    with open(out, "w") as f:
        json.dump({"dumps": dumps, "cycles": lockdep.cycles(),
                   "edges": {k: list(v) for k, v in lockdep.edges().items()},
                   "iterations": i, "trigger": box["trigger"]}, f)
    hvd.shutdown()


def test_sigusr2_storm_under_lockdep_raise(tmp_path):
    out = str(tmp_path / "out.json")
    env = rank_env(None, HVD_TPU_LOCKDEP="raise",
                   HVD_TPU_FLIGHTREC_DIR=str(tmp_path / "boxes"))
    proc = subprocess.Popen([sys.executable, __file__, "--sigusr2-worker",
                             out], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(out + ".ready"):
            assert proc.poll() is None, proc.communicate()[0]
            assert time.monotonic() < deadline
            time.sleep(0.05)
        for _ in range(SIGNALS):
            os.kill(proc.pid, signal.SIGUSR2)
            time.sleep(0.05)
        open(out + ".stop", "w").close()
        log = proc.communicate(timeout=60)[0]
    finally:
        proc.kill()
    assert proc.returncode == 0, log[-3000:]
    res = json.loads(open(out).read())
    assert res["dumps"] == SIGNALS and res["trigger"] == "sigusr2"
    assert res["cycles"] == [] and res["iterations"] > 0
    assert res["edges"], "lockdep recorded nothing"


# -- podmon ----------------------------------------------------------------------

def _snap(rank, host, step_time=None, steps=None, resyncs=0, comm=None,
          hist=None):
    labels = {"rank": str(rank), "size": "3", "host": host}
    snap = {"hvd_tpu_recovery_total": {"type": "counter", "help": "",
            "samples": [{"labels": {**labels,
                                    "counter": "divergence_resyncs"},
                         "value": resyncs}]},
            "hvd_tpu_stall_warnings_total": {"type": "counter", "help": "w",
            "samples": [{"labels": labels, "value": float(rank)}]}}
    if step_time is not None:
        snap["hvd_tpu_autoscale_step_time_seconds"] = {
            "type": "gauge", "help": "",
            "samples": [{"labels": dict(labels), "value": step_time}]}
    if steps is not None:
        snap["hvd_tpu_autoscale_steps_total"] = {
            "type": "counter", "help": "",
            "samples": [{"labels": dict(labels), "value": steps}]}
    if hist is not None:
        snap["hvd_tpu_step_seconds"] = {
            "type": "histogram", "help": "",
            "samples": [{"labels": dict(labels), "value": {
                "sum": hist[0], "count": hist[1], "buckets": {}}}]}
    if comm is not None:
        snap["hvd_tpu_step_phase_seconds"] = {
            "type": "histogram", "help": "", "samples": [
                {"labels": {**labels, "phase": p},
                 "value": {"sum": v, "count": 1, "buckets": {}}}
                for p, v in (("comm", comm[0]), ("grad", comm[1]))]}
    return snap


SNAPS = {"a:1": _snap(0, "hostA", 0.10, 12, comm=(0.2, 0.6)),
         "b:2": _snap(1, "hostB", 0.12, 12, resyncs=2),
         "c:3": _snap(2, "hostC", 0.61, 11, hist=(5.0, 10)),
         "d:4": _snap(3, "hostD", hist=(4.0, 8)),
         "e:5": {"hvd_tpu_x": {"type": "gauge", "help": "",
                               "samples": [{"labels": {}, "value": 1}]}}}


@pytest.mark.parametrize("endpoints", [
    ["a:1", "b:2", "c:3"], ["a:1", "b:2", "c:3", "d:4", "e:5"],
    ["c:3"], ["dead:9", "a:1"]])
def test_pod_monitor_matches_jax_on_recorded_snapshots(J, monkeypatch,
                                                       endpoints):
    monkeypatch.delenv("HVD_TPU_PARALLEL", raising=False)
    mons = {}
    for name, mod in (("jax", J.podmon), ("port", P_podmon)):
        mon = mod.PodMonitor(lambda: list(endpoints), clock=lambda: 5.0)
        mon._fetch = lambda ep: json.loads(json.dumps(SNAPS[ep])) \
            if ep in SNAPS else None
        for _ in range(2):
            mon.scrape_once()
        mons[name] = mon
    jm, pm = mons["jax"].merged(), mons["port"].merged()
    assert json.dumps(pm, sort_keys=True) == json.dumps(jm, sort_keys=True)
    assert mons["port"].prometheus_text() == mons["jax"].prometheus_text()
    assert {r: dataclasses.asdict(v) for r, v in
            mons["port"].reports().items()} == \
        {r: dataclasses.asdict(v) for r, v in mons["jax"].reports().items()}
    for snap in SNAPS.values():
        assert P_podmon.step_time_from_snapshot(snap) == \
            J.podmon.step_time_from_snapshot(snap)
        assert P_podmon.step_count_from_snapshot(snap) == \
            J.podmon.step_count_from_snapshot(snap)


def test_pod_monitor_scrapes_live_endpoints_and_serves_pod_metrics():
    regs, servers, ports = [], [], []
    try:
        for rank, host in enumerate(("hostA", "hostB")):
            reg = P_metrics.MetricsRegistry(enabled=True)
            reg.set_global_labels(rank=str(rank), size="2", host=host)
            reg.gauge("hvd_tpu_autoscale_step_time_seconds").set(
                0.1 * (rank + 1))
            srv = P_metrics.MetricsServer(reg=reg, host="127.0.0.1")
            ports.append(srv.start(0))
            regs.append(reg)
            servers.append(srv)
        mon = P_podmon.PodMonitor(P_podmon.static_endpoints(
            ",".join(f"127.0.0.1:{p}" for p in ports)), interval_s=60)
        pod_port = mon.start(0)
        try:
            assert mon.scrape_once() == 2
            code, body = _get(f"http://127.0.0.1:{pod_port}/pod/metrics")
            assert code == 200 and body == mon.prometheus_text()
            assert "hvd_tpu_pod_slowest_rank 1" in body
            code, body = _get(
                f"http://127.0.0.1:{pod_port}/pod/metrics.json")
            view = json.loads(body)
            assert view["ranks"] == [0, 1] and "snapshots" not in view
            assert view["step_skew_seconds"] == pytest.approx(0.1)
        finally:
            mon.stop()
    finally:
        for srv in servers:
            srv.stop()


def test_role_views_raise_naming_their_slice(monkeypatch):
    """The role views are ported: an explicit spec, else
    ``HVD_TPU_PARALLEL``, labels the per-rank series (their parity with
    JAX runs in ``test_torch_port_elastic_hybrid.py``); what still raises
    is a value that is no spec."""
    with pytest.raises((TypeError, ValueError)):
        P_podmon.PodMonitor(lambda: [], parallel=object())
    monkeypatch.setenv("HVD_TPU_PARALLEL", "dp=2,pp=2")
    mon = P_podmon.PodMonitor(lambda: [])
    assert mon.parallel.describe() == "dp=2,pp=2"
    assert mon.reports() == {} and mon.merged()["roles"] == {}


if __name__ == "__main__":
    if sys.argv[1] == "--stall-worker":
        _stall_worker(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1] == "--sigusr2-worker":
        _sigusr2_worker(sys.argv[2])
