"""The port's role-aware elastic slice against the JAX package's: the
autoscale engine under a hybrid ParallelSpec (the whole-replica floor,
replica-grouped straggler scoring, ``plan_respec``), the pod monitor's
role views, the elastic driver's respec epochs, and the sharded state
carried across a respec.

* Engine parity: the same seeded ``StepReport`` sequences (with roles)
  and the same ``plan_respec`` capacities under one injected clock give
  byte-identical decision logs from both engines, on ``dp=2,pp=2`` and
  ``dp=2,pp=2,tp=2``. The oracles of ``tests/test_respec.py`` (the
  floor, conviction, ``plan_respec`` and its metric, the publisher's
  role, the driver's exact assignment) are mirrored on the port.
* Pod views: ``merged()``, ``prometheus_text()`` and ``reports()`` of
  both monitors fed the same snapshots are equal (the oracles of
  ``tests/test_podmon.py``'s role section mirrored).
* State across a respec: gloo worlds on ``gpt_tiny`` with
  ``ZeroOptimizer(parallel=, zero_stage=1, compression="int8_ef")``
  AdamW, each pp rank holding its stage, checkpointed with
  ``save_sharded(opt.sharded_tree(names))`` under the global leaf names
  of ``gpt.global_param_names``. Each stage's state gathered on the old
  world (``gather_state``, cut by leaf) is BITWISE the state restored on
  the new world: ``shed_dp`` (dp=2,pp=2 -> dp=1,pp=2), back up
  (dp=1,pp=2 -> dp=2,pp=2), ``fold_pp`` (dp=1,pp=2 -> dp=1,pp=1: the
  stage layers from the rank files that wrote them, the shared leaves
  from stage 0's), and a torn newest checkpoint walks back one step.
  Each rank runs this file as ``--respec-worker RANK MODE OUT CKPT``.
* The CPU journey: ``hvdtpurun-torch --elastic -np 4 --min-np 2 -H
  hostA:1,hostB:1,hostC:1,hostD:1`` under ``HVD_TPU_PARALLEL=dp=2,pp=2``
  over ``chip_smoke.py``'s hybrid elastic worker (``gpt_tiny``), a
  straggler on hostC: exactly ``evict hostC`` (role ``dp1/pp0``) then
  ``respec dp=1,pp=2`` (``shed_dp``), rc 0, the final loss within
  ``0.02 |ref| + 1e-3`` of an uninterrupted dp=2,pp=2 run of the same
  steps and data (in the first world's processes, before the elastic
  run; the JAX chaos test's bound), the global batch fixed across the
  respec; a ``--min-np 3`` launch fails naming the roles.

JAX is imported only inside the ``J`` fixture.
"""

import dataclasses
import json
import os
import random
import sys
import types

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint as ckpt
from horovod_tpu_torch.common import autoscale as P
from horovod_tpu_torch.common import fusion as fusion_lib
from horovod_tpu_torch.common import podmon as P_podmon
from horovod_tpu_torch.models import gpt
from horovod_tpu_torch.parallel import pipeline as pl
from horovod_tpu_torch.parallel import respec as P_respec
from horovod_tpu_torch.parallel.mesh import local_batch
from horovod_tpu_torch.parallel.spec import ParallelSpec
from test_torch_port_worlds import REPO, run_ranks, session_world, world_slot

SPEC4 = "dp=2,pp=2"
SPEC8 = "dp=2,pp=2,tp=2"


@pytest.fixture(scope="module")
def J():
    from horovod_tpu.common import autoscale, podmon
    from horovod_tpu.parallel import spec

    return types.SimpleNamespace(autoscale=autoscale, podmon=podmon,
                                 spec=spec)


# -- the engine: byte-identical decision logs ----------------------------------

class _Harness:
    """One engine of either package over ``spec`` (``None``: role-blind),
    a fake clock, seeded reports; ``trace`` collects every return."""

    def __init__(self, mod, spec, log_path, **policy):
        base = dict(straggler_ratio=2.0, straggler_patience=2, min_ranks=3,
                    evict_cooldown_s=0.0, tick_interval_s=1.0)
        base.update(policy)
        self.mod, self.now, self.reports, self.trace = mod, 0.0, {}, []
        self.spec = ParallelSpec.parse(spec or SPEC8)
        self.total = self.spec.total
        self.hosts = [f"host{chr(65 + i)}" for i in range(
            self.total // self.spec.replica_ranks * 2)]
        self.per_host = self.total // len(self.hosts)
        self.engine = mod.AutoscaleEngine(
            mod.AutoscalePolicy.from_dict(base),
            min_np=self.spec.replica_ranks, max_np=self.total,
            fetch_reports=lambda: dict(self.reports),
            clock=lambda: self.now, log_path=log_path, parallel=spec)

    def feed(self, step, rng, slow_rank=None, slow=0.5, fast=0.05,
             bleed=0.8, skip=(), noise=0.05):
        for r in range(self.total):
            if r in skip:
                self.reports.pop(r, None)
                continue
            p50 = fast * (1 + noise * rng.random())
            if slow_rank is not None and self.spec.replica_of(r) == \
                    self.spec.replica_of(slow_rank):
                p50 = slow if r == slow_rank else \
                    p50 + bleed * (slow - fast)
            self.reports[r] = self.mod.StepReport(
                rank=r, host=self.hosts[r // self.per_host], step=step,
                n=8, p50=p50, mean=p50, last=p50,
                role=self.spec.role_label(r))

    def tick(self):
        self.now += 1.0
        out = self.engine.tick({h: self.per_host for h in self.hosts}, {})
        self.trace.append([d.log_line() for d in out])

    def respec(self, cap):
        d = self.engine.plan_respec(cap)
        cur = self.engine.current_spec
        self.trace.append(("respec", cap, None if d is None else
                           (d.action, d.spec.describe(), d.np),
                           None if cur is None else cur.describe()))


def _straggler(h, rng):
    for i in range(6):
        h.feed(i * 5, rng, slow_rank=h.total // 2 + 1)
        h.tick()
    for cap in (h.total, h.total - h.per_host, h.total // 2 - 1, 1,
                h.total):
        h.respec(cap)


def _uniform(h, rng):
    for i in range(6):
        h.feed(i * 5, rng, slow_rank=h.total // 2 + 1, bleed=1.0)
        h.tick()


def _single_replica(h, rng):
    for i in range(6):
        h.feed(i * 5, rng, slow_rank=h.total // 2 + 1,
               skip=range(h.total // 2))
        h.tick()


def _ladder(h, rng):
    for cap in range(h.total + 1, 0, -1):
        h.respec(cap)
    h.respec(h.total)
    h.feed(0, rng)
    h.tick()


SCENARIOS = {"straggler": _straggler, "uniform": _uniform,
             "single_replica": _single_replica, "ladder": _ladder}


@pytest.mark.parametrize("spec", [SPEC4, SPEC8, None])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_role_aware_decision_log_is_byte_identical_to_jax(J, spec, name,
                                                          tmp_path):
    runs = {}
    for pkg, mod in (("jax", J.autoscale), ("port", P)):
        log = tmp_path / f"{pkg}.jsonl"
        h = _Harness(mod, spec, str(log))
        SCENARIOS[name](h, random.Random(1717))
        runs[pkg] = (h.trace, h.engine.decision_log(), log.read_bytes()
                     if log.exists() else b"", h.engine.min_np,
                     h.engine.min_world)
    assert runs["port"] == runs["jax"]
    if name in ("straggler", "ladder") and spec is not None:
        assert runs["port"][2], "the scenario decided nothing"


# -- the oracles of tests/test_respec.py, on the port -------------------------

def test_policy_min_np_rejects_partial_replica_floor():
    spec = ParallelSpec.parse(SPEC8)
    pol = P.AutoscalePolicy.from_dict({"min_np": 3})
    with pytest.raises(ValueError) as e:
        pol.resolve_min_np(1, spec)
    msg = str(e.value)
    assert "pp=2" in msg and "tp=2" in msg and SPEC8 in msg
    assert "use 4, 8" in msg
    with pytest.raises(ValueError, match="min_np=6"):
        P.AutoscalePolicy().resolve_min_np(6, spec)
    assert pol.resolve_min_np(1, None) == 3
    assert P.AutoscalePolicy.from_dict({"min_np": 8}).resolve_min_np(
        1, spec) == 8
    assert P.AutoscalePolicy().resolve_min_np(4, spec) == 4


def test_engine_ctor_validates_floor_against_spec():
    with pytest.raises(ValueError, match="multiple of the model-replica"):
        P.AutoscaleEngine(P.AutoscalePolicy(), min_np=3, max_np=8,
                          fetch_reports=dict, log_path="", parallel=SPEC8)
    eng = P.AutoscaleEngine(P.AutoscalePolicy(), min_np=4, max_np=8,
                            fetch_reports=dict, log_path="",
                            parallel=SPEC8)
    assert eng.min_np == 4 and eng.min_world == 1
    assert eng.current_spec.describe() == SPEC8
    blind = P.AutoscaleEngine(P.AutoscalePolicy(), min_np=3, max_np=8,
                              fetch_reports=dict, log_path="")
    assert blind.min_world is None and blind.current_spec is None


def _port_harness(spec=SPEC8, **policy):
    return _Harness(P, spec, "", **policy)


def test_role_aware_conviction_names_host_not_pipeline_peers():
    h = _port_harness()
    evictions = []
    for i in range(6):
        h.feed(i * 5, random.Random(i), slow_rank=5)
        h.tick()
    evictions = [d for d in h.engine.decisions if d.action == "evict"]
    assert evictions and all(d.target == "hostC" for d in evictions)
    d = evictions[0]
    assert (d.target, d.reason, d.role) == ("hostC", "straggler",
                                            "dp1/pp0/tp1")
    assert json.loads(d.log_line())["role"] == "dp1/pp0/tp1"


def test_role_blind_engine_would_convict_the_whole_replica():
    h = _port_harness(spec=None)
    struck = set()
    for i in range(6):
        h.feed(i * 5, random.Random(i), slow_rank=5)
        h.tick()
        struck |= set(h.engine._strikes)
    struck |= {d.target for d in h.engine.decisions if d.action == "evict"}
    assert {"hostC", "hostD"} <= struck, struck


def test_uniformly_slow_replica_and_single_replica_are_not_convicted():
    for skip in ((), range(4)):
        h = _port_harness()
        for i in range(6):
            h.feed(i * 5, random.Random(i), slow_rank=5,
                   bleed=1.0 if not skip else 0.8, skip=skip, noise=0.0)
            h.tick()
        assert not [d for d in h.engine.decisions if d.action == "evict"]


def _respec_count(frm, to):
    from horovod_tpu_torch.common import metrics as metrics_lib

    return sum(s["value"] for s in metrics_lib.snapshot().get(
        "hvd_tpu_respec_total", {}).get("samples", [])
        if s["labels"].get("from") == frm and s["labels"].get("to") == to)


def test_plan_respec_records_decision_and_metric():
    from horovod_tpu_torch.common import metrics as metrics_lib

    h = _port_harness()
    before = _respec_count(SPEC8, "dp=1,pp=2,tp=2")
    assert h.engine.plan_respec(8) is None
    d = h.engine.plan_respec(6)
    assert d is not None and d.action == "shed_dp" and d.np == 4
    assert h.engine.current_spec.describe() == "dp=1,pp=2,tp=2"
    assert h.engine.plan_respec(6) is None
    d2 = h.engine.plan_respec(8)
    assert d2 is not None and d2.action == "keep"
    assert h.engine.current_spec.describe() == SPEC8
    log = [json.loads(line) for line in h.engine.decision_log()]
    assert [(x["action"], x["target"], x["reason"]) for x in log] == [
        ("respec", "dp=1,pp=2,tp=2", "shed_dp"),
        ("respec", SPEC8, "restore")]
    if metrics_lib.enabled():
        assert _respec_count(SPEC8, "dp=1,pp=2,tp=2") == before + 1


def test_plan_respec_disabled_and_role_blind(monkeypatch):
    assert _port_harness(spec=None).engine.plan_respec(6) is None
    monkeypatch.setenv(P_respec.ENV_ENABLE, "0")
    h = _port_harness()
    assert h.engine.min_world == 8
    assert h.engine.plan_respec(6) is None
    assert h.engine.current_spec.describe() == SPEC8


def test_step_report_role_round_trip_and_publisher_stamp(J, monkeypatch):
    r = P.StepReport(rank=5, host="hostC", step=3, n=8, p50=0.1, mean=0.1,
                     last=0.1, role="dp1/pp0/tp1")
    assert P.StepReport.from_json(r.to_json().encode()).role == \
        "dp1/pp0/tp1"
    assert r.to_json() == J.autoscale.StepReport(
        **dataclasses.asdict(r)).to_json()
    blind = P.StepReport(rank=0, host="a", step=1, n=1, p50=0.1, mean=0.1,
                         last=0.1)
    assert "role" not in blind.to_json()
    monkeypatch.setenv("HVD_TPU_PARALLEL", SPEC8)
    assert P.StepPublisher(client=None, rank=5, host="hostC").role == \
        "dp1/pp0/tp1" == J.autoscale.StepPublisher(
            client=None, rank=5, host="hostC").role
    assert P.StepPublisher(client=None, rank=9, host="x").role is None
    monkeypatch.delenv("HVD_TPU_PARALLEL")
    assert P.StepPublisher(client=None, rank=5, host="hostC").role is None


def test_driver_assignment_cap_exact_below_min_np():
    from horovod_tpu_torch.runner.elastic_driver import (ElasticDriver,
                                                         FixedHostDiscovery)

    drv = ElasticDriver(FixedHostDiscovery({"a": 2, "b": 2, "c": 2}),
                        min_np=6, max_np=8, discovery_interval=0.01)
    drv.host_manager.update_available_hosts()
    assert len(drv.update_assignments(np_cap=5)) == 6
    assert len(drv.update_assignments(np_exact=4)) == 4


# -- the pod monitor's role views ---------------------------------------------

def _snap(rank, host, step_time, steps=7):
    labels = {"rank": str(rank), "host": host}
    return {"hvd_tpu_autoscale_step_time_seconds": {
                "type": "gauge", "help": "",
                "samples": [{"labels": dict(labels), "value": step_time}]},
            "hvd_tpu_autoscale_steps_total": {
                "type": "counter", "help": "",
                "samples": [{"labels": dict(labels), "value": steps}]},
            "hvd_tpu_recovery_total": {
                "type": "counter", "help": "",
                "samples": [{"labels": {**labels,
                                        "counter": "divergence_resyncs"},
                             "value": 0}]}}


def _views(mod, spec, times, monkeypatch, ratio=None, by_env=False,
           parse=ParallelSpec.parse):
    if ratio is not None:
        monkeypatch.setenv("HVD_TPU_POD_REPLICA_SKEW_RATIO", str(ratio))
    if by_env:
        monkeypatch.setenv("HVD_TPU_PARALLEL", spec)
        mon = mod.PodMonitor(lambda: [], interval_s=999)
    else:
        monkeypatch.delenv("HVD_TPU_PARALLEL", raising=False)
        mon = mod.PodMonitor(lambda: [], interval_s=999,
                             parallel=parse(spec))
    for r, st in times.items():
        host = f"host{r // 2}"
        mon._ranks[r] = {"snapshot": _snap(r, host, st), "host": host,
                         "t": 1.0, "endpoint": f"{host}:1"}
    return (json.dumps(mon.merged(), sort_keys=True), mon.prometheus_text(),
            {r: dataclasses.asdict(v) for r, v in mon.reports().items()})


POD_CASES = {
    "even": (SPEC8, {r: 0.1 for r in range(8)}, None),
    "stalled": (SPEC8, {r: (0.55 if r == 5 else 0.5) if r >= 4 else 0.1
                        for r in range(8)}, None),
    "pp_world": (SPEC4, {0: 0.1, 1: 0.12, 2: 0.9, 3: 0.7}, None),
    "ratio": (SPEC4, {0: 0.1, 1: 0.12, 2: 0.2, 3: 0.2}, 1.2),
    "partial": (SPEC4, {0: 0.1, 2: 0.9, 7: 0.3}, None),
    "one_replica": (SPEC4, {0: 0.1, 1: 0.4}, None)}


@pytest.mark.parametrize("by_env", [False, True])
@pytest.mark.parametrize("case", sorted(POD_CASES))
def test_pod_role_views_match_jax(J, monkeypatch, case, by_env):
    spec, times, ratio = POD_CASES[case]
    port = _views(P_podmon, spec, times, monkeypatch, ratio, by_env)
    jax = _views(J.podmon, spec, times, monkeypatch, ratio, by_env,
                 J.spec.ParallelSpec.parse)
    assert port == jax


def test_pod_role_views_oracles(monkeypatch):
    merged, text, reports = _views(P_podmon, SPEC8, POD_CASES["stalled"][1],
                                   monkeypatch)
    m = json.loads(merged)
    assert m["roles"]["5"] == "dp1/pp0/tp1"
    assert m["role_coords"]["3"] == {"dp": 0, "pp": 1, "tp": 1}
    assert m["replica_step_time_seconds"]["1"] == pytest.approx(0.5)
    assert m["stalled_replicas"] == [1] and m["slowest_rank"] == 5
    assert ('hvd_tpu_pod_step_time_seconds{dp="1",host="host2",pp="0",'
            'rank="5",tp="1"}') in text
    assert 'hvd_tpu_pod_replica_stalled{replica="0"} 0' in text
    assert 'hvd_tpu_pod_replica_stalled{replica="1"} 1' in text
    assert reports[5]["role"] == "dp1/pp0/tp1"
    monkeypatch.delenv("HVD_TPU_PARALLEL", raising=False)
    mon = P_podmon.PodMonitor(lambda: [], interval_s=999)
    assert mon.parallel is None
    mon._ranks[0] = {"snapshot": _snap(0, "hostA", 0.1), "host": "hostA",
                     "t": 1.0, "endpoint": "hostA:1"}
    assert mon.merged()["roles"] == {}
    assert "hvd_tpu_pod_replica_stalled" not in mon.prometheus_text()


# -- the state across a respec (gloo worlds) ----------------------------------

TINY = dict(num_layers=2, hidden=64, num_heads=4, mlp_dim=128,
            vocab_size=128)
ROWS, SEQ = 4, 16               # the global batch: one row a microbatch
RESPEC_MODES = {                # mode: (spec, restore from, save into,
    "a": ("dp=2,pp=2", None, "A", (1, 2)),   # steps trained)
    "b": ("dp=1,pp=2", "A", "B", (3, 4)),
    "c": ("dp=2,pp=2", "B", None, ()),
    "d": ("dp=1,pp=1", "B", None, ()),
    "e": ("dp=1,pp=2", "B", None, ())}


def _stage_model(spec, rank):
    """This rank's stage of the seeded ``gpt_tiny`` and its global leaf
    names."""
    npp = spec.size_of("pp")
    s = spec.coords(rank)["pp"]
    torch.manual_seed(0)
    full = gpt.gpt_tiny(**TINY)
    stages, shared = gpt.stack_stage_params(full, npp)
    m = gpt.gpt_tiny(**dict(TINY, num_layers=TINY["num_layers"] // npp))
    m.load_state_dict({**stages[s], **shared})
    return m, gpt.global_param_names(m, s, npp)


def _by_leaf(opt, names, model, out, tag):
    """The stage's state gathered over dp (``gather_state``), cut by leaf
    name, and the parameters, into ``out``."""
    full = opt.gather_state()
    plan = opt.shard_state.plan
    for bi, entry in full["state"].items():
        b = plan.buckets[int(bi)]
        for k, v in entry.items():
            if torch.is_tensor(v) and v.dim():
                for i, view in fusion_lib.unfuse_bucket(v, b):
                    out[f"{tag}/state/{names[i]}/{k}"] = view.numpy().copy()
            else:
                for i in b.leaf_indices:
                    out[f"{tag}/scalar/{names[i]}/{k}"] = np.asarray(
                        torch.as_tensor(v)).copy()
    for r, b in zip(full["ef_state"]["residual"], plan.buckets):
        for i, view in fusion_lib.unfuse_bucket(r, b):
            out[f"{tag}/res/{names[i]}"] = view.numpy().copy()
    out[f"{tag}/ef_step"] = np.int64(full["ef_state"]["step"])
    for name, p in zip(names, model.parameters()):
        out[f"{tag}/param/{name}"] = p.detach().numpy().copy()


def _respec_worker(rank: int, mode: str, out_path: str, root: str) -> None:
    torch.set_num_threads(1)
    spec_str, src, dst, steps = RESPEC_MODES[mode]
    hvd.init(device="cpu", parallel=spec_str)
    spec = hvd.parallel_spec()
    dp = spec.size_of("dp")
    model, names = _stage_model(spec, rank)
    opt = hvd.ZeroOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4),
        zero_stage=1, compression="int8_ef", parallel=spec_str)
    out = {}
    if src is not None:
        tree, step = hvd.restore_sharded(opt.restore_template(names),
                                         os.path.join(root, src))
        opt.load_sharded_tree(tree, names)
        out["restored_step"] = np.int64(step)
        out["restored_by"] = np.array(opt.last_restore)
        _by_leaf(opt, names, model, out, "restored")
    sf, pf, lf = gpt.pipeline_fns(model)
    vg = pl.pipeline_accumulate_gradients(sf, lf, accum_steps=ROWS // dp,
                                          axis_name="pp", pre_fn=pf)
    tree = {"stages": gpt.stage_params(model),
            "shared": gpt.shared_params(model)}
    for step in steps:
        g = torch.Generator().manual_seed(100 + step)
        toks = torch.randint(0, TINY["vocab_size"], (ROWS, SEQ + 1),
                             generator=g)
        x = local_batch(toks[:, :-1], spec, rank)
        y = local_batch(toks[:, 1:], spec, rank)
        opt.zero_grad()
        vg(tree, x, y)
        opt.step()
        hvd.save_sharded(opt.sharded_tree(names), os.path.join(root, dst),
                         step)
        _by_leaf(opt, names, model, out, f"s{step}")
    np.savez(f"{out_path}.rank{rank}.npz", **out)
    hvd.shutdown()


def _run_respec(root, mode, n):
    run_ranks(__file__, lambda r: ["--respec-worker", r, mode,
                                   os.path.join(root, mode), root], n,
              timeout=240)
    return [dict(np.load(os.path.join(root, f"{mode}.rank{r}.npz")))
            for r in range(n)]


@pytest.fixture(scope="module")
def respec_worlds(tmp_path_factory):
    def run(root):
        root = str(root)
        _run_respec(root, "a", 4)
        _run_respec(root, "b", 2)
        _run_respec(root, "c", 4)
        _run_respec(root, "d", 1)
        # The newest step torn on one rank: the world walks back to 3.
        ckpt.CheckpointManager(os.path.join(root, "B", "rank1"),
                               writer=False)._corrupt_step(4)
        _run_respec(root, "e", 2)

    out = session_world(tmp_path_factory, "torch_respec", run)
    return {mode: [dict(np.load(out / f"{mode}.rank{r}.npz"))
                   for r in range(n)]
            for mode, n in (("a", 4), ("b", 2), ("c", 4), ("d", 1),
                            ("e", 2))}


def _same(got: dict, want: dict, tag_got: str, tag_want: str,
          keep=lambda key: True):
    keys = sorted(k[len(tag_want) + 1:] for k in want
                  if k.startswith(tag_want + "/") and keep(k))
    assert keys and any("/res/" in f"/{k}" for k in keys)
    for k in keys:
        np.testing.assert_array_equal(got[f"{tag_got}/{k}"],
                                      want[f"{tag_want}/{k}"], err_msg=k)
    return keys


def test_respec_shed_dp_restores_each_stage_bitwise(respec_worlds):
    """dp=2,pp=2 -> dp=1,pp=2: each new rank's stage (the same pp
    coordinate) holds, per leaf, the old world's gathered state: AdamW's
    moments and step, the int8_ef residual's sum over the old dp grid,
    the rounding step and the parameters."""
    a, b = respec_worlds["a"], respec_worlds["b"]
    for s in (0, 1):
        np.testing.assert_equal(a[s]["s2/ef_step"], a[s + 2]["s2/ef_step"])
        assert b[s]["restored_step"] == 2
        assert str(b[s]["restored_by"]) == "piecewise"
        keys = _same(b[s], a[s], "restored", "s2")
        assert any("/state/" in f"/{k}" and k.endswith("exp_avg")
                   for k in keys)
    # The stages hold their own layers under their global names.
    assert any("layers.1." in k for k in b[1] if k.startswith("restored/"))
    assert not any("layers.0." in k for k in b[1]
                   if k.startswith("restored/"))


def test_respec_grow_back_restores_bitwise(respec_worlds):
    """dp=1,pp=2 -> dp=2,pp=2: both dp ranks of a stage gather the state
    the world of 2 saved at its last step."""
    b, c = respec_worlds["b"], respec_worlds["c"]
    for r in range(4):
        s = r % 2
        assert c[r]["restored_step"] == 4
        assert str(c[r]["restored_by"]) == "piecewise"
        _same(c[r], b[s], "restored", "s4")


def test_respec_fold_pp_restores_every_layer_bitwise(respec_worlds):
    """dp=1,pp=2 -> dp=1,pp=1: the one rank's template is the union of
    the stages; each stage's layers come from the rank file that wrote
    them, the shared leaves (held by both stages) from stage 0's."""
    b, (d,) = respec_worlds["b"], respec_worlds["d"]
    assert d["restored_step"] == 4
    assert str(d["restored_by"]) == "gathered"
    on_stage1 = lambda k: "layers.1." in k        # noqa: E731
    _same(d, b[0], "restored", "s4", keep=lambda k: not on_stage1(k))
    _same(d, b[1], "restored", "s4", keep=on_stage1)
    got = {k for k in d if k.startswith("restored/")}
    want = {"restored/" + k[3:] for s in (0, 1) for k in b[s]
            if k.startswith("s4/")}
    assert got == want


def test_respec_torn_checkpoint_walks_back_one_step(respec_worlds):
    b, e = respec_worlds["b"], respec_worlds["e"]
    for s in (0, 1):
        assert e[s]["restored_step"] == 3
        _same(e[s], b[s], "restored", "s3")


# -- the CPU journey ------------------------------------------------------------

JOURNEY = dict(widths=dict(hidden=64, num_heads=4, mlp_dim=128,
                           vocab_size=128),
               layers=2, run={"rows": ROWS, "seq": SEQ, "steps": 20},
               straggle={"delay_s": 0.5}, policy={"tick_interval_s": 1.5},
               timeout=240, expect_launches=False)


def test_cpu_journey_sheds_a_replica_and_trains_on(tmp_path):
    """The port's small form of ``tests/test_chaos.py::
    test_chaos_hybrid_host_loss_respec_and_migrate``, through
    ``chip_smoke.elastic_hybrid`` (phase 13's own checks: the exact
    decisions, the replica-stall gauge and the role labels on
    /pod/metrics, the driver's respec counter, the worlds, every restore
    at the newest step saved by every rank and bitwise its saved pieces,
    the loss bound) on ``gpt_tiny``'s widths."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    out = tmp_path / "out"
    out.mkdir()
    with world_slot():
        rec = cs.elastic_hybrid(
            str(tmp_path), str(out), dev="cpu",
            env_extra={"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"},
            **JOURNEY)
    assert [(d["action"], d["target"], d.get("role"), d["reason"])
            for d in rec["decisions"]] == [
        ("evict", "hostC", "dp1/pp0", "straggler"),
        ("respec", "dp=1,pp=2", None, "shed_dp")]
    assert not any(d["target"] == "hostD" for d in rec["decisions"])
    assert rec["worlds"] == [4, 2]
    assert abs(rec["final_loss"] - rec["ref_loss"]) <= \
        0.02 * abs(rec["ref_loss"]) + 1e-3
    # The global batch stays 4 rows: 2 microbatches a replica at dp=2,
    # 4 at dp=1.
    assert (rec["micro_n4"], rec["micro_n2"]) == (2, 4)
    assert rec["min_np3"]["rc"] not in (0, None)
    assert "pp=2" in rec["min_np3"]["message"] and \
        "dp=2,pp=2" in rec["min_np3"]["message"]


if __name__ == "__main__" and sys.argv[1:2] == ["--respec-worker"]:
    _respec_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
