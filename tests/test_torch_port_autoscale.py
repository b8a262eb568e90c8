"""The port's autoscale control plane (``horovod_tpu_torch/common/
autoscale.py``, the elastic driver's engine and pod monitor, the
launcher's flags) against the JAX package's, after the reference tests
``tests/test_autoscale.py``.

* Policies: the same JSON round trips, and a bad field names itself.
* The engine: the same seeded ``StepReport`` sequences under one
  injected clock give byte-identical decision logs from both engines —
  evict after the patience ticks, the ``min_np`` block, the quorum,
  cooldowns, permanent escalation, grow and the grow hold, stall and
  divergence shrinks, blacklist strikes.
* The publisher: the ``straggler`` site's ``scale`` inflates only the
  report; ``note_step`` publishes over the rendezvous KV. In ONE gloo
  world of 3, where a sleeping rank delays every rank at the next
  collective, the port's step time (the commit interval less the time
  blocked in collectives) flags only the sleeping rank.
* The launcher: ``--autoscale-policy`` inline, ``@file`` and file forms,
  a bad field's exit, ``--check-build``.
* The CPU live smoke: ``hvdtpurun-torch --elastic -np 3 --min-np 1
  --max-np 3 -H hostA:1,hostB:1,hostC:1`` over ``chip_smoke.py``'s
  elastic worker (``gpt_tiny``) under ``tools/chaos_soak.py``'s policy
  with a straggler on hostC: evict hostC, grow, evict hostC for good,
  every step finished; and a fatal stall on hostB leaves a black box
  from every rank in which ``tools/flight_diff.py`` names hostB. The
  two runs take ≈ 70 s on an idle 8-core CPU host; each is held to its
  launches (four epochs, two) and to 90 s.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
import types

import pytest

from horovod_tpu_torch.common import autoscale as P
from horovod_tpu_torch.runner import launch
from test_torch_port_worlds import REPO, run_ranks, world_slot

STRAGGLE_S = 0.15
WORLD_STEPS = 10
LIVE_LIMIT_S = 90


@pytest.fixture(scope="module")
def J():
    from horovod_tpu.common import autoscale
    from horovod_tpu.runner import launch as jlaunch

    return types.SimpleNamespace(autoscale=autoscale, launch=jlaunch)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the policy ------------------------------------------------------------------

@pytest.mark.parametrize("data", [
    {}, {"straggler_ratio": 4.0, "window": 16},
    {"enabled": "yes", "min_np": "2", "evict_ttl_s": 3},
    {"tick_interval_s": 0.25, "evict_permanent_after": 2,
     "grow_min_comm_fraction": 0.5, "max_blacklist_strikes": 3}])
def test_policy_round_trips_as_jax(J, data):
    p = P.AutoscalePolicy.from_dict(dict(data))
    j = J.autoscale.AutoscalePolicy.from_dict(dict(data))
    assert p.to_json() == j.to_json()
    assert P.AutoscalePolicy.from_json(p.to_json()) == p


@pytest.mark.parametrize("data,field", [
    ({"stragler_ratio": 2.0}, "stragler_ratio"),
    ({"window": "huge"}, "'window'"),
    ({"straggler_ratio": 0.5}, "straggler_ratio"),
    ({"tick_interval_s": -1}, "tick_interval_s"),
    ({"straggler_patience": 0}, "straggler_patience"),
    ({"min_np": -1}, "min_np")])
def test_bad_policy_field_names_itself(J, data, field):
    with pytest.raises(ValueError, match=field) as pe:
        P.AutoscalePolicy.from_dict(dict(data))
    with pytest.raises(ValueError) as je:
        J.autoscale.AutoscalePolicy.from_dict(dict(data))
    assert str(pe.value) == str(je.value)


def test_policy_env_overrides_and_enable_resolution(J, monkeypatch):
    monkeypatch.setenv("HVD_TPU_AUTOSCALE_POLICY",
                       '{"straggler_ratio": 4.0, "window": 16}')
    monkeypatch.setenv("HVD_TPU_AUTOSCALE_STRAGGLER_RATIO", "6.0")
    assert P.AutoscalePolicy.from_env().to_json() == \
        J.autoscale.AutoscalePolicy.from_env().to_json()
    assert P.autoscale_enabled()
    monkeypatch.setenv("HVD_TPU_AUTOSCALE", "0")
    assert not P.autoscale_enabled() and not \
        J.autoscale.autoscale_enabled()


# -- the engine: byte-identical decision logs ------------------------------------

class _Harness:
    """One engine, a fake clock and a mutable report table, for either
    package; ``trace`` collects every return value."""

    def __init__(self, mod, policy, min_np=1, max_np=3):
        self.mod, self.now, self.reports, self.trace = mod, 0.0, {}, []
        self.engine = mod.AutoscaleEngine(
            mod.AutoscalePolicy.from_dict(policy), min_np, max_np,
            lambda: dict(self.reports), clock=lambda: self.now,
            log_path="")

    def report(self, rank, host, step, p50, **kw):
        self.reports[rank] = self.mod.StepReport(
            rank=rank, host=host, step=step, n=8, p50=p50, mean=p50,
            last=p50, **kw)

    def tick(self, hosts, blacklist=None, dt=1.0):
        self.now += dt
        out = self.engine.tick(hosts, blacklist or {})
        self.trace.append([d.log_line() for d in out])
        return out

    def pre_epoch(self, prev, hosts):
        self.trace.append(("pre_epoch", self.engine.pre_epoch(prev, hosts)))


def _policy(**over):
    base = dict(straggler_ratio=2.0, straggler_patience=2, min_ranks=3,
                evict_ttl_s=10.0, evict_cooldown_s=0.0,
                grow_cooldown_s=0.0, tick_interval_s=1.0)
    base.update(over)
    return base


HOSTS3 = {"a": 1, "b": 1, "c": 1}


def _feed(h, i, slow_host="c", slow=0.5, fast=0.05):
    for r, host in enumerate("abc"):
        h.report(r, host, step=i * 5, p50=slow if host == slow_host
                 else fast)


def _patience_then_evict(h):
    for i in range(5):
        _feed(h, i)
        h.tick(HOSTS3)
    for i in range(5, 9):     # stale c: no re-conviction
        h.report(0, "a", step=i * 5, p50=0.05)
        h.report(1, "b", step=i * 5, p50=0.05)
        h.tick(HOSTS3)


def _min_np_block(h):
    for i in range(6):
        _feed(h, i)
        h.tick(HOSTS3)


def _quorum(h):
    for i in range(5):
        h.report(0, "a", step=i * 5, p50=0.05)
        h.report(2, "c", step=i * 5, p50=0.5)
        h.tick({"a": 1, "c": 1})


def _cooldown(h):
    for i in range(3):
        _feed(h, i)
        h.tick(HOSTS3)
    for i in range(3, 7):
        h.report(0, "a", step=i * 5, p50=0.05)
        h.report(1, "b", step=i * 5, p50=0.5)
        h.tick({"a": 1, "b": 1})


def _permanent(h):
    for i in range(12):
        _feed(h, i)
        h.tick(HOSTS3)


def _grow_after_evict(h):
    h.engine.observe_assignment({"a", "b", "c"})
    for i in range(4):
        _feed(h, i)
        h.tick(HOSTS3)
    h.pre_epoch(3, {"a": 1, "b": 1})
    h.engine.observe_assignment({"a", "b"})
    h.pre_epoch(2, HOSTS3)
    h.pre_epoch(2, HOSTS3)
    h.engine.observe_assignment({"a", "b", "c"})
    h.pre_epoch(3, {"a": 1, "b": 1, "c": 1, "d": 1})


def _grow_hold(h):
    h.engine.observe_assignment({"a", "b"})
    h.report(0, "a", 5, 0.05, comm_fraction=0.1)
    h.report(1, "b", 5, 0.05, comm_fraction=0.1)
    h.tick({"a": 1, "b": 1})
    h.pre_epoch(2, {"a": 1, "b": 1, "d": 1})
    for i in (2, 3):
        h.report(0, "a", 5 * i, 0.05, comm_fraction=0.8)
        h.report(1, "b", 5 * i, 0.05, comm_fraction=0.8)
        h.tick({"a": 1, "b": 1})
    h.pre_epoch(2, {"a": 1, "b": 1, "d": 1})
    h.pre_epoch(3, {"a": 1, "b": 1, "d": 1, "e": 1})


def _stall_shrink(h):
    hosts4 = {"a": 1, "b": 1, "c": 1, "d": 1}
    shrunk = []
    for i in range(12):
        h.report(0, "a", step=i * 5, p50=0.05)
        for r, host in ((1, "b"), (2, "c"), (3, "d")):
            if host not in shrunk:
                h.report(r, host, step=5, p50=0.05)
        for d in h.tick({k: v for k, v in hosts4.items()
                         if k not in shrunk}):
            shrunk.append(d.target)
            h.reports.pop({"b": 1, "c": 2, "d": 3}[d.target], None)


def _divergence(h):
    for r, host in enumerate("abc"):
        h.report(r, host, 5, 0.05, resyncs=int(host == "c"))
    h.tick(HOSTS3)
    h.report(2, "c", 10, 0.05, resyncs=3)
    h.tick(HOSTS3)
    for r, host in enumerate("ab"):        # a global counter: no one
        h.report(r, host, 15, 0.05, resyncs=5)
    h.tick({"a": 1, "b": 1})


def _strikes(h):
    bl = {"c": {"strikes": 3, "remaining_s": 5.0}}
    h.tick(HOSTS3, blacklist=bl)
    h.tick(HOSTS3, blacklist=bl)


def _keeps_only(h):
    for i in range(20):
        _feed(h, i, slow=0.05)
        h.tick(HOSTS3)


SCENARIOS = {
    "patience_then_evict": (_patience_then_evict, _policy(), 1, 3),
    "min_np_block": (_min_np_block, _policy(), 3, 3),
    "quorum": (_quorum, _policy(min_ranks=3), 1, 3),
    "cooldown": (_cooldown, _policy(evict_cooldown_s=100.0), 1, 3),
    "permanent": (_permanent, _policy(evict_permanent_after=2,
                                      evict_ttl_s=1.0), 1, 3),
    "grow_after_evict": (_grow_after_evict, _policy(), 1, 3),
    "grow_hold": (_grow_hold, _policy(grow_min_comm_fraction=0.5), 1, 3),
    "stall_shrink": (_stall_shrink, _policy(stall_timeout_s=3.0), 1, 4),
    "divergence": (_divergence, _policy(max_divergence_resyncs=2), 1, 3),
    "blacklist_strikes": (_strikes, _policy(max_blacklist_strikes=3), 1,
                          3),
    "keeps_only": (_keeps_only, _policy(), 1, 3),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decision_log_is_byte_identical_to_jax(J, name, tmp_path):
    script, policy, min_np, max_np = SCENARIOS[name]
    runs = {}
    for pkg, mod in (("jax", J.autoscale), ("port", P)):
        h = _Harness(mod, policy, min_np, max_np)
        h.engine._log_path = str(tmp_path / f"{pkg}.jsonl")
        script(h)
        runs[pkg] = (h.trace, h.engine.decision_log(),
                     (tmp_path / f"{pkg}.jsonl").read_bytes()
                     if (tmp_path / f"{pkg}.jsonl").exists() else b"")
    assert runs["port"] == runs["jax"]
    if name in ("patience_then_evict", "permanent", "grow_after_evict",
                "stall_shrink", "divergence", "blacklist_strikes",
                "cooldown", "grow_hold"):
        assert runs["port"][1], "the scenario decided nothing"


def test_engine_refuses_a_parallel_spec():
    """The role-aware engine is ported: a ParallelSpec is taken, and what
    it refuses is a floor that splits a model replica (naming the roles)
    or a value that is no spec."""
    eng = P.AutoscaleEngine(P.AutoscalePolicy(), 2, 4, dict,
                            parallel="dp=2,pp=2")
    assert eng.current_spec.describe() == "dp=2,pp=2"
    assert eng.min_world == 1
    with pytest.raises(ValueError, match="roles pp=2"):
        P.AutoscaleEngine(P.AutoscalePolicy(), 3, 4, dict,
                          parallel="dp=2,pp=2")
    with pytest.raises((TypeError, ValueError)):
        P.AutoscaleEngine(P.AutoscalePolicy(), 1, 3, dict,
                          parallel=object())


# -- the publisher -----------------------------------------------------------------

class _Sink:
    def __init__(self):
        self.puts = []

    def put(self, scope, key, value):
        self.puts.append((scope, key, json.loads(value.decode())))


def test_straggler_scale_inflates_the_report_only(J, monkeypatch):
    from horovod_tpu.common import faults as jfaults

    from horovod_tpu_torch.common import faults

    monkeypatch.setenv("HVD_TPU_FAULT_PLAN", json.dumps(
        {"seed": 1, "faults": [{"site": "straggler", "step": 1,
                                "times": 0, "scale": 50.0}]}))
    got = {}
    try:
        for name, mod, flt in (("jax", J.autoscale, jfaults),
                               ("port", P, faults)):
            flt.refresh_from_env()
            # The report carries the process's recovery counters: start
            # both packages' from zero (an earlier test in this process
            # may have counted a resync in one of them).
            flt.stats.reset()
            sink, clock = _Sink(), [0.0]
            pub = mod.StepPublisher(sink, rank=0, host="h", window=4,
                                    publish_interval_s=0.0,
                                    clock=lambda: clock[0])
            for _ in range(3):
                clock[0] += 0.01
                pub.note()
            got[name] = sink.puts[-1][2]
    finally:
        monkeypatch.delenv("HVD_TPU_FAULT_PLAN")
        faults.refresh_from_env()
        jfaults.refresh_from_env()
    for name in got:
        got[name].pop("comm_fraction", None)
    assert got["port"] == got["jax"]
    assert got["port"]["p50"] == pytest.approx(0.5)


def test_step_publisher_over_the_kv(monkeypatch):
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer

    srv = RendezvousServer("127.0.0.1", secret=b"pk")
    port = srv.start()
    try:
        monkeypatch.setenv("HVD_TPU_RENDEZVOUS_SECRET", "pk")
        monkeypatch.setenv("HVD_TPU_AUTOSCALE", "1")
        monkeypatch.setenv("HVD_TPU_AUTOSCALE_POLICY",
                           '{"publish_interval_s": 0.0, "window": 4}')
        monkeypatch.setenv("HVD_TPU_RENDEZVOUS", f"127.0.0.1:{port}")
        monkeypatch.setenv("HVD_TPU_PROC_ID", "3")
        monkeypatch.setenv("HVD_TPU_HOSTNAME", "hostX")
        P._reset_publisher_for_tests()
        try:
            for _ in range(4):
                P.note_step()
            r = P.kv_report_fetcher(srv)()[3]
            assert r.host == "hostX" and r.step == 3 and r.p50 >= 0
        finally:
            P._reset_publisher_for_tests()
    finally:
        srv.stop()


def test_comm_clock_leaves_blocked_time_out_of_the_step():
    sink, clock, comm = _Sink(), [0.0], [0.0]
    pub = P.StepPublisher(sink, rank=0, host="h", window=4,
                          publish_interval_s=0.0, clock=lambda: clock[0],
                          comm_seconds=lambda: comm[0])
    pub.note()
    for _ in range(3):
        clock[0] += 1.0         # a 1 s interval, 0.75 s of it blocked
        comm[0] += 0.75
        pub.note()
    rec = sink.puts[-1][2]
    assert rec["p50"] == pytest.approx(0.25)
    assert rec["comm_fraction"] == pytest.approx(0.75)
    c = P.CommClock()
    with c.waiting():
        with c.waiting():       # nested: counted once
            time.sleep(0.05)
    assert 0.05 <= c.total() < 0.2 and not c.active()


def _straggler_world_worker(rank: int, out: str) -> None:
    """One rank of a world of 3: each step computes, allreduces (the
    eager engine) and commits through a StepPublisher; rank 2 sleeps in
    its commit (the ``straggler`` site)."""
    import torch

    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    sink = _Sink()
    pub = P.StepPublisher(sink, rank=rank, host=f"host{rank}", window=8,
                          publish_interval_s=0.0)
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(rank))
    intervals, last = [], None
    for _ in range(WORLD_STEPS):
        for _ in range(4):
            x = torch.tanh(x @ x.T / 64)
        hvd.allreduce(x, name="grad")
        pub.note()
        now = time.monotonic()
        if last is not None:
            intervals.append(now - last)
        last = now
    with open(out, "w") as f:
        json.dump({"reports": [p[2] for p in sink.puts],
                   "intervals": intervals}, f)
    hvd.shutdown()


def test_straggler_in_one_world_flags_only_the_sleeping_rank(tmp_path):
    plan = {"seed": 3, "faults": [{"site": "straggler", "step": 1,
                                   "times": 0, "rank": 2,
                                   "delay_s": STRAGGLE_S}]}
    run_ranks(__file__, lambda r: ["--straggler-worker", r,
                                   tmp_path / f"out{r}.json"], 3,
              timeout=120, HVD_TPU_FAULT_PLAN=json.dumps(plan))
    outs = [json.loads((tmp_path / f"out{r}.json").read_text())
            for r in range(3)]
    # The wall interval between commits is the world's: every rank's is
    # stretched by the sleep (the JAX publisher's measure flags nobody).
    walls = [sorted(o["intervals"])[len(o["intervals"]) // 2] for o in outs]
    assert min(walls) > 0.8 * STRAGGLE_S and max(walls) < 1.25 * min(walls)
    # The busy time separates them, and the engine convicts host2 alone.
    p50 = [o["reports"][-1]["p50"] for o in outs]
    assert p50[2] > 1.5 * max(p50[0], p50[1]), p50
    engine = P.AutoscaleEngine(
        P.AutoscalePolicy.from_dict({"straggler_ratio": 1.5,
                                     "straggler_patience": 2,
                                     "evict_cooldown_s": 0.0}),
        1, 3, lambda: reports)
    hosts = {f"host{r}": 1 for r in range(3)}
    decisions = []
    for k in range(len(outs[0]["reports"])):
        reports = {r: P.StepReport(**outs[r]["reports"][k])
                   for r in range(3)}
        decisions = engine.tick(hosts)
        if decisions:
            break
    assert [(d.action, d.target, d.reason) for d in decisions] == \
        [("evict", "host2", "straggler")]


# -- the launcher ------------------------------------------------------------------

def test_autoscale_policy_flag_forms_match_jax(J, tmp_path):
    pol = tmp_path / "policy.json"
    pol.write_text('{"evict_ttl_s": 60.0}')
    for value in ('{"straggler_ratio": 3.0}', f"@{pol}", str(pol)):
        argv = ["--autoscale-policy", value, "--autoscale-log",
                str(tmp_path / "d.jsonl"), "--", "true"]
        env = launch.knob_env(launch.parse_args(argv))
        assert env == J.launch.knob_env(J.launch.parse_args(argv))
        assert env["HVD_TPU_AUTOSCALE"] == "1"
    bad = ["--autoscale-policy", '{"stragler_ratio": 3.0}', "--", "true"]
    with pytest.raises(ValueError, match="stragler_ratio"):
        launch.knob_env(launch.parse_args(bad))


def test_bad_policy_exits_naming_the_field(capsys):
    assert launch.run_commandline(
        ["--autoscale-policy", '{"window": "huge"}', sys.executable, "-c",
         "pass"]) == 2
    assert "'window'" in capsys.readouterr().err


def test_check_build_names_the_port(capsys):
    assert launch.run_commandline(["--check-build"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("horovod_tpu_torch v")
    assert "Gloo (torch.distributed)" in out and "adasum.cu" in out


# -- the CPU live smoke --------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LIVE_ENV = {"OMP_NUM_THREADS": "1", "HVD_TPU_ELASTIC_GRACE_SECS": "10",
            "PYTHONPATH": str(REPO)}
_LIVE = {}


def _live_runs(tmp_path_factory):
    if _LIVE:
        return _LIVE
    cs = _chip_smoke()
    soak = _load_tool("chaos_soak")
    cfg = {"model": "gpt_tiny", "device": "cpu", "batch": 2, "seq": 16,
           "persist_every": 0, "qmin": 0, "final_check": False,
           "loss_allreduce": True, "persist_at_exit": True}
    # A tick spans a step of the world: its ranks commit in lockstep,
    # and the straggler publishes its sleep later. The exile outlasts
    # the eviction's epoch change, so the world runs at 2 before hostC
    # returns (a shorter one can expire before the next assignment).
    policy = dict(soak.autoscale_policy(tick_s=0.75), evict_ttl_s=4.0)
    with world_slot():
        work = tmp_path_factory.mktemp("live_straggler")
        log = work / "decisions.jsonl"
        t0 = time.perf_counter()
        rc, _, events, inj, text = cs.run_elastic_job(
            str(work), dict(cfg, steps=30, shift_plan=False),
            {"seed": 42, "faults": [{"site": "straggler", "step": 1,
                                     "times": 0, "host": "hostC",
                                     "delay_s": 0.45}]},
            env_extra=LIVE_ENV, timeout=120,
            hosts="hostA:1,hostB:1,hostC:1", nps=(3, 1, 3),
            launcher_args=["--autoscale-policy", json.dumps(policy),
                           "--autoscale-log", str(log)])
        _LIVE["straggler"] = dict(
            rc=rc, events=events, injections=inj, log=text,
            wall=time.perf_counter() - t0,
            decisions=[json.loads(x) for x in log.read_text().splitlines()]
            if log.exists() else [])
        work = tmp_path_factory.mktemp("live_stall")
        boxes = work / "boxes"
        t0 = time.perf_counter()
        rc, _, events, inj, text = cs.run_elastic_job(
            str(work), dict(cfg, steps=5),
            # The fatal bound (also the peers' collective timeout) is
            # long enough for the peers' side of hostB's stalled
            # allreduce to finish on a loaded machine, so their rings
            # are one collective ahead of hostB's.
            {"seed": 7, "faults": [{"site": "collective_stall", "step": 3,
                                    "host": "hostB", "delay_s": 9.0}]},
            env_extra={**LIVE_ENV, "HVD_TPU_FLIGHTREC_DIR": str(boxes),
                       "HVD_TPU_STALL_CHECK_TIME_SECONDS": "3",
                       "HVD_TPU_STALL_SHUTDOWN_TIME_SECONDS": "6",
                       "HVD_TPU_BLACKLIST_TTL_S": "1"},
            timeout=120, hosts="hostA:1,hostB:1,hostC:1", nps=(3, 2, 3))
        fd = subprocess.run([sys.executable, str(REPO / "tools" /
                                                 "flight_diff.py"),
                             "--json", str(boxes)], capture_output=True,
                            text=True, timeout=60)
        _LIVE["stall"] = dict(rc=rc, events=events, injections=inj,
                              log=text, wall=time.perf_counter() - t0,
                              boxes=boxes, flight_diff=fd)
    return _LIVE


def _epochs(events) -> int:
    """How many times the workers were started (their start and restore
    events, a world's worth at a time)."""
    starts = sorted(e["t"] for evs in events.values() for e in evs
                    if e["event"] in ("start", "restore"))
    return sum(1 for a, b in zip([None] + starts, starts)
               if a is None or b - a > 2.0)


def test_live_straggler_evicted_regrown_and_exiled(tmp_path_factory):
    run = _live_runs(tmp_path_factory)["straggler"]
    assert run["rc"] == 0, run["log"][-4000:]
    acts = [(d["action"], d["target"], d["reason"])
            for d in run["decisions"]]
    # The invariants the JAX live soak holds, and the escalation: the
    # second eviction is permanent (evict_permanent_after = 2), so the
    # run ends in a world of 2.
    assert acts[0] == ("evict", "hostC", "straggler"), acts
    assert ("grow", "1", "capacity_available") in acts, acts
    assert [a for a in acts if a[0] == "evict"] == \
        [("evict", "hostC", "straggler")] * 2, acts
    finals = [e for evs in run["events"].values() for e in evs
              if e["event"] == "final"]
    assert len(finals) == 2 and all(e["step"] == 30 and e["n"] == 2
                                    for e in finals), finals
    restores = [e["digest_ok"] for evs in run["events"].values()
                for e in evs if e["event"] == "restore"]
    assert restores and all(restores)
    worlds = _chip_smoke()._world_sequence(run["events"])
    assert worlds[:4] == [3, 2, 3, 2], worlds
    # Four epochs and no more (each costs a start of every worker, most
    # of the run's time: ≈ 40 s on an idle 8-core host), inside the
    # run's budget.
    assert _epochs(run["events"]) == 4 and run["wall"] < LIVE_LIMIT_S


def test_live_fatal_stall_leaves_every_ranks_box(tmp_path_factory):
    runs = _live_runs(tmp_path_factory)
    run = runs["stall"]
    assert run["rc"] == 0, run["log"][-4000:]
    # The failing epoch and the one that finishes (≈ 30 s on an idle
    # 8-core host).
    assert _epochs(run["events"]) == 2 and run["wall"] < LIVE_LIMIT_S
    fd = _load_tool("flight_diff")
    boxes = {r: fd.load_blackbox(str(run["boxes"] /
                                     f"blackbox.rank{r}.json"))
             for r in range(3)}
    assert boxes[1]["host"] == "hostB"
    assert boxes[1]["trigger"] in ("sigusr2", "stall_timeout")
    assert {boxes[r]["trigger"] for r in (0, 2)} <= {"peer_failure",
                                                      "sigusr2"}
    assert run["flight_diff"].returncode == 0, run["flight_diff"].stderr
    report = json.loads(run["flight_diff"].stdout)
    assert report["ranks"] == [0, 1, 2]
    assert report["laggard_rank"] == 1
    assert any("rank 1 never completed allreduce.loss" in v
               for f in report["findings"] for v in f["verdicts"])
    finals = [e for evs in run["events"].values() for e in evs
              if e["event"] == "final"]
    assert finals and all(e["step"] == 5 for e in finals), finals


if __name__ == "__main__":
    if sys.argv[1] == "--straggler-worker":
        _straggler_world_worker(int(sys.argv[2]), sys.argv[3])
