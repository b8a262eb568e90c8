"""The port's launcher (``horovod_tpu_torch/runner/``) against the JAX
package's (``horovod_tpu/runner/``), after the reference tests of
``tests/test_runner.py``, ``tests/test_elastic.py`` and
``tests/test_faults.py``.

* ``parse_hosts``, ``parse_host_files``, ``get_host_assignments``,
  ``build_env_for_slot`` and ``knob_env`` give the JAX launcher's
  results for the same inputs; the flags of the later slices are taken
  and hosts beyond this machine go through the ssh fan-out.
* The rendezvous digest is the JAX package's; a server/client round trip
  with a secret works (403 without it, 409 on a lost put-if-absent, an
  injected 5xx retried); each package's client talks to the other's
  server.
* ``HostManager``'s blacklist, its TTL and the strike doubling, and
  ``ElasticDriver``'s rank-stable assignment behave as JAX's under one
  fake clock.
* ``hvd.run`` and ``hvdtpurun-torch -np 2`` start real gloo worlds on
  this machine; a failing worker fails the launch.
* The chaos smoke, end to end: ``hvdtpurun-torch --elastic -np 2
  --min-np 2 --max-np 2 -H hostA:1,hostB:1`` over ``chip_smoke.py``'s
  elastic worker (``gpt_tiny`` on the CPU, int8_ef AdamW, commit every
  step, persist every 3) under ``tools/chaos_soak.py``'s
  ``default_plan(7)`` plus a hard crash of hostB's worker: exit 0, the
  final step reached, the four fault families injected, every restore
  and the persisted state bitwise the commit they came from, the final
  state bitwise an uninterrupted run's, in under 60 s.
"""

import importlib.util
import json
import os
import sys
import time
import types
import urllib.error

import pytest

from horovod_tpu_torch.common import faults
from horovod_tpu_torch.runner import elastic_driver as ed
from horovod_tpu_torch.runner import hosts
from horovod_tpu_torch.runner import launch
from horovod_tpu_torch.runner import rendezvous as rdv
from test_torch_port_worlds import REPO, world_slot

CHAOS_LIMIT_S = 60
CHAOS_STEPS = 9


@pytest.fixture(scope="module")
def J():
    from horovod_tpu.runner import elastic_driver as jed
    from horovod_tpu.runner import hosts as jhosts
    from horovod_tpu.runner import launch as jlaunch
    from horovod_tpu.runner import rendezvous as jrdv

    return types.SimpleNamespace(hosts=jhosts, launch=jlaunch, rdv=jrdv,
                                 ed=jed)


@pytest.mark.parametrize("spec", ["h1:4,h2:4", "a, b:2 ,c:1", "solo",
                                  "x:3,,y:1"])
def test_parse_and_assign_match_jax(J, spec):
    mine, theirs = hosts.parse_hosts(spec), J.hosts.parse_hosts(spec)
    assert [vars(h) for h in mine] == [vars(h) for h in theirs]
    total = sum(h.slots for h in mine)
    for np_ in range(1, total + 1):
        a = hosts.get_host_assignments(mine, np_)
        b = J.hosts.get_host_assignments(theirs, np_)
        assert [vars(s) for s in a] == [vars(s) for s in b]
    for mod, infos in ((hosts, mine), (J.hosts, theirs)):
        with pytest.raises(ValueError, match="slots"):
            mod.get_host_assignments(infos, total + 1)


def test_hostfile_matches_jax(J, tmp_path):
    f = tmp_path / "hosts"
    f.write_text("# comment\nh1 slots=4\nh2\n\nh3 slots = 2  # trailing\n")
    assert [vars(h) for h in hosts.parse_host_files(str(f))] == \
        [vars(h) for h in J.hosts.parse_host_files(str(f))]


def test_slot_env_and_knobs_match_jax(J, tmp_path):
    base = {"PATH": "/bin", "HVD_TPU_METRICS_FILE": "/tmp/m.jsonl"}
    for np_, pid in ((1, 0), (4, 3)):
        assert launch.build_env_for_slot(base, "c:1", np_, pid,
                                         {"X": "1"}) == \
            J.launch.build_env_for_slot(base, "c:1", np_, pid, {"X": "1"})
    plan = tmp_path / "plan.json"
    plan.write_text('[{"site": "crash", "step": 3}]')
    argv = ["-np", "2", "--fusion-threshold-mb", "32", "--cache-capacity",
            "0", "--hierarchical-allreduce", "--timeline-filename", "t.json",
            "--stall-check-time-seconds", "7", "--compression", "bf16",
            "--metrics-file", "m.jsonl", "--elastic", "--fault-plan",
            f"@{plan}", "--log-level", "info", "python", "x.py"]
    assert launch.knob_env(launch.parse_args(argv)) == \
        J.launch.knob_env(J.launch.parse_args(argv))
    bad = launch.parse_args(["--fault-plan", '[{"site": "x", "step": 1}]',
                             "python"])
    with pytest.raises(ValueError, match="unknown fault site"):
        launch.knob_env(bad)


@pytest.mark.parametrize("flag", [["--autotune"], ["--metrics-port", "0"],
                                  ["--pod-metrics-port", "0"],
                                  ["--autoscale-policy", "{}"],
                                  ["--check-build"]])
def test_later_flags_raise_naming_their_slice(flag, capsys):
    """The flags of the later slices are taken: ``--autotune`` (slice 14)
    and the telemetry and control flags (slice 13) — a launch with each
    runs its worker to exit 0 — and ``--check-build`` prints the port's
    matrix."""
    argv = flag + [sys.executable, "-c", "pass"]
    assert launch.run_commandline(argv) == 0
    if flag == ["--check-build"]:
        out = capsys.readouterr().out
        assert "horovod_tpu_torch" in out and "PyTorch (native)" in out


def test_remote_hosts_raise_naming_the_ssh_slice(tmp_path, monkeypatch):
    """Hosts beyond this machine are ported (slice 14): they go through
    the ssh fan-out — here an ``ssh`` on ``PATH`` that logs its host and
    runs the command on this machine — one process a slot."""
    fake = tmp_path / "ssh"
    log = tmp_path / "ssh.log"
    fake.write_text(
        "#!/bin/bash\n"
        "args=()\n"
        "while [[ $# -gt 0 ]]; do\n"
        "  case $1 in\n"
        "    -o|-p) shift 2;;\n"
        "    *) args+=(\"$1\"); shift;;\n"
        "  esac\n"
        "done\n"
        f"echo \"${{args[0]}}\" >> {log}\n"
        "exec bash -c \"${args[*]:1}\"\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    assert launch.run_commandline(["-np", "2", "-H", "far1:1,far2:1",
                                   sys.executable, "-c", "pass"]) == 0
    assert sorted(log.read_text().split()) == ["far1", "far2"]


# -- rendezvous ---------------------------------------------------------------

def test_rendezvous_digest_matches_jax(J):
    for args in ((b"k", "PUT", "/kv/a/b", b"v"),
                 (b"secret", "GET", "/kv/s?list=1", b""),
                 (b"", "DELETE", "/kv/x/y", b"")):
        assert rdv._digest(*args) == J.rdv._digest(*args)


@pytest.fixture()
def fast_retries(monkeypatch):
    monkeypatch.delenv("HVD_TPU_RENDEZVOUS_SECRET", raising=False)
    monkeypatch.setenv("HVD_TPU_RENDEZVOUS_BACKOFF_BASE_S", "0.01")
    monkeypatch.setenv("HVD_TPU_RENDEZVOUS_BACKOFF_MAX_S", "0.02")
    yield
    faults.uninstall()


def test_rendezvous_round_trip(J, fast_retries):
    srv = rdv.RendezvousServer("127.0.0.1", secret=b"job")
    port = srv.start()
    try:
        c = rdv.RendezvousClient("127.0.0.1", port, secret=b"job")
        c.put("s", "k", b"v1")
        assert c.get("s", "k") == b"v1" and c.get("s", "none") is None
        assert c.put_if_absent("s", "k", b"v2") == b"v1"
        assert c.list("s") == ["k"]
        assert c.wait("s", "k", timeout_s=1) == b"v1"
        # The JAX client speaks the same protocol and digest.
        jc = J.rdv.RendezvousClient("127.0.0.1", port, secret=b"job")
        assert jc.get("s", "k") == b"v1"
        c.delete("s", "k")
        assert c.get("s", "k") is None
        bad = rdv.RendezvousClient("127.0.0.1", port, secret=b"wrong")
        with pytest.raises(urllib.error.HTTPError) as e:
            bad.get("s", "k")
        assert e.value.code == 403
        srv.put("elastic", "topology_version", b"3")
        assert c.get("elastic", "topology_version") == b"3"
        assert srv.scope_items("elastic") == {"topology_version": b"3"}
        faults.install(faults.FaultPlan.from_json(
            '[{"site": "rendezvous", "step": 1, "times": 2}]'),
            log_path="")
        before = faults.recovery_stats()["rendezvous_retries"]
        assert c.get("elastic", "topology_version") == b"3"
        assert faults.recovery_stats()["rendezvous_retries"] == before + 2
        with pytest.raises(TimeoutError):
            c.wait("s", "never", timeout_s=0.2)
    finally:
        srv.stop()


# -- the driver's bookkeeping ---------------------------------------------------

def _blacklist_script(mod):
    t = {"now": 100.0}
    hm = mod.HostManager(mod.FixedHostDiscovery({"a": 1, "b": 2}),
                         blacklist_ttl_s=50.0, clock=lambda: t["now"])
    seen = [hm.update_available_hosts()]
    for dt, op in ((0, "bl"), (0, "up"), (49, "chk"), (2, "up"), (0, "bl"),
                   (51, "chk"), (50, "chk"), (0, "up")):
        t["now"] += dt
        if op == "bl":
            hm.blacklist("b")
        elif op == "up":
            seen.append(hm.update_available_hosts())
        seen.append((hm.is_blacklisted("b"), hm.current_hosts(),
                     {k: v["strikes"] for k, v in
                      hm.blacklist_snapshot().items()}))
    hm.blacklist("a", permanent=True)
    seen.append(hm.permanently_exhausted())
    return seen


def test_host_manager_blacklist_and_ttl_match_jax(J):
    assert _blacklist_script(ed) == _blacklist_script(J.ed)


def _assignment_script(mod):
    disco = {"h1": 2, "h2": 2}
    d = mod.ElasticDriver(mod.FixedHostDiscovery(disco), 2, 8)
    d.host_manager.update_available_hosts()
    out = [[vars(s) for s in d.update_assignments()]]
    d.host_manager._discovery = mod.FixedHostDiscovery(
        {"h0": 1, "h2": 2, "h1": 2})
    d.host_manager.update_available_hosts()
    out.append([vars(s) for s in d.update_assignments()])
    d.record_failure("h1")
    d.host_manager.update_available_hosts()
    out.append([vars(s) for s in d.update_assignments()])
    return out


def test_rank_stable_assignment_matches_jax(J, monkeypatch):
    monkeypatch.setenv("HVD_TPU_BLACKLIST_TTL_S", "300")
    assert _assignment_script(ed) == _assignment_script(J.ed)


# -- launches -------------------------------------------------------------------

def _allreduce_rank():
    import torch

    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        out = hvd.allreduce(torch.tensor([float(hvd.rank() + 1)]),
                            op=hvd.Sum)
        return hvd.rank(), hvd.size(), float(out[0])
    finally:
        hvd.shutdown()


def test_run_returns_each_ranks_result(monkeypatch):
    from horovod_tpu_torch.runner import run

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(REPO), str(REPO / "tests")]))
    with world_slot():
        got = run(_allreduce_rank, np=2)
    assert got == [(0, 2, 3.0), (1, 2, 3.0)]


def test_launcher_local_world_and_fail_fast(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    script = tmp_path / "w.py"
    out = tmp_path / "out"
    script.write_text(
        "import sys, torch, horovod_tpu_torch as hvd\n"
        "hvd.init(device='cpu')\n"
        "s = hvd.allreduce(torch.ones(2), op=hvd.Sum)\n"
        "r = hvd.rank()\n"
        f"open(r'{out}' + str(r), 'w').write(str(float(s[0])))\n"
        "hvd.shutdown()\n"
        "sys.exit(int(sys.argv[1]) if r == 1 else 0)\n")
    with world_slot():
        assert launch.run_commandline(
            ["-np", "2", sys.executable, str(script), "0"]) == 0
        assert launch.run_commandline(
            ["-np", "2", sys.executable, str(script), "3"]) == 3
    assert (tmp_path / "out0").read_text() == "2.0"


# -- the chaos smoke ------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chaos_plan():
    spec = importlib.util.spec_from_file_location(
        "chaos_soak", REPO / "tools" / "chaos_soak.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    plan = mod.default_plan(7)
    plan["faults"].append({"site": "crash", "step": 6, "host": "hostB"})
    return plan


_CHAOS = {}


def _chaos_runs(tmp_path_factory):
    if not _CHAOS:
        cs = _chip_smoke()
        cfg = {"model": "gpt_tiny", "device": "cpu", "batch": 2, "seq": 32,
               "steps": CHAOS_STEPS, "persist_every": 3, "qmin": 0}
        env = {"OMP_NUM_THREADS": "1", "HVD_TPU_BLACKLIST_TTL_S": "1",
               "HVD_TPU_ELASTIC_GRACE_SECS": "10",
               "PYTHONPATH": str(REPO)}
        runs = (("chaos", dict(cfg, final_check=True), _chaos_plan()),
                # As in phase 8: the clean run persists nothing.
                ("clean", dict(cfg, persist_every=0, final_check=False),
                 None))
        with world_slot():
            for name, run_cfg, plan in runs:
                t0 = time.perf_counter()
                rc, _, events, inj, log = cs.run_elastic_job(
                    str(tmp_path_factory.mktemp(name)), run_cfg, plan,
                    env_extra=env, timeout=180)
                _CHAOS[name] = dict(
                    rc=rc, wall=time.perf_counter() - t0, events=events,
                    injections=inj, log=log,
                    report=cs.elastic_report(events, inj))
    return _CHAOS


def test_chaos_smoke_through_the_launcher(tmp_path_factory):
    run = _chaos_runs(tmp_path_factory)["chaos"]
    assert run["rc"] == 0, run["log"][-4000:]
    assert run["wall"] < CHAOS_LIMIT_S, run["wall"]
    sites = sorted({i["site"] for i in run["injections"]})
    assert sites == ["collective", "crash", "preempt", "rendezvous"], sites
    rep = run["report"]
    assert all(f["recover_s"] is not None for f in rep["faults"]), rep
    assert rep["restores"] and all(ok for _, ok in rep["restores"]), rep
    for r, final in rep["finals"].items():
        assert final is not None, r
        assert final["step"] == CHAOS_STEPS
        assert final["persisted_step"] == CHAOS_STEPS
        assert final["persisted_equal"] and final["committed_equal"], final


def test_chaos_run_ends_bitwise_as_an_uninterrupted_run(tmp_path_factory):
    runs = _chaos_runs(tmp_path_factory)
    clean = runs["clean"]
    assert clean["rc"] == 0 and not clean["injections"]
    assert not clean["report"]["restores"]
    for r in (0, 1):
        assert runs["chaos"]["report"]["finals"][r]["digest"] == \
            clean["report"]["finals"][r]["digest"]
    # The replayed steps repeat their losses exactly.
    losses = {}
    for step, loss in runs["chaos"]["report"]["losses_rank0"]:
        assert losses.setdefault(step, loss) == loss, step
    assert losses == dict(clean["report"]["losses_rank0"])
