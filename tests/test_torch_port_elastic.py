"""The port's fault plan and elastic layer (``horovod_tpu_torch/common/
faults.py``, ``common/elastic.py``, ``elastic.py``, ``checkpoint.
save_state``/``restore_state``, ``integrity.chaos_poison``/
``chaos_perturb``) against the JAX package's, after the reference tests
of ``tests/test_faults.py`` and ``tests/test_elastic.py``.

* The same plan and seed give the same injection sequence, site by site
  and hit by hit (step, probability, times, rank and host specs), and
  ``Backoff`` the same delays under the same seeded jitter.
* ``ObjectState`` and ``TorchState`` commit, restore and sync (one
  process; two gloo ranks, where ``sync`` takes rank 0's weights and
  AdamW state and leaves each rank its own int8_ef residual).
* ``run`` on a scripted sequence of exceptions gives the JAX ``run``'s
  reset and restore counts and surfaces the same non-comm error.
* ``_is_comm_failure`` on a REAL gloo failure: the other rank of a
  2-rank world exits while this one is in an ``all_reduce``.
* ``run`` in process, in a world of one, over a DistributedOptimizer
  (int8_ef) and a ZeRO stage-3 optimizer with overlap off and on: a
  second reduction round that fails mid-step (the ``collective`` site,
  or a failed hop) is rolled back and the run ends bitwise equal to an
  uninterrupted one.
* ``save_state``/``restore_state``: a round trip of a TorchState, and a
  corrupted last step (the ``checkpoint_corrupt`` site) walks back.
* ``chaos_poison`` and ``chaos_perturb`` equal JAX's under one plan.

JAX is imported only inside the ``J`` fixture.
"""

import json
import os
import random
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint as ckpt
from horovod_tpu_torch import elastic
from horovod_tpu_torch.common import elastic as elastic_lib
from horovod_tpu_torch.common import faults
from horovod_tpu_torch.common import integrity
from horovod_tpu_torch.common.exceptions import (HorovodInternalError,
                                                 HostsUpdatedInterrupt)
from test_torch_port_worlds import rank_env, run_procs, run_ranks

PLAN = {"seed": 42, "faults": [
    {"site": "collective", "step": 2},
    {"site": "collective", "step": 5, "times": 3},
    {"site": "rendezvous", "probability": 0.3, "times": 0},
    {"site": "crash", "step": 3, "rank": 1},
    {"site": "preempt", "step": 1, "host": "hostB"},
    {"site": "discovery", "probability": 0.5, "times": 2,
     "mode": "drop_host", "target": "h1"},
    {"site": "nonfinite", "step": 4, "mode": "inf"}]}
SITES = ("collective", "rendezvous", "crash", "preempt", "discovery",
         "nonfinite")


@pytest.fixture(scope="module")
def J():
    from horovod_tpu.common import elastic as jelastic
    from horovod_tpu.common import faults as jfaults
    from horovod_tpu.common import integrity as jintegrity
    from horovod_tpu.common.exceptions import (
        HorovodInternalError as JInternal, HostsUpdatedInterrupt as JHosts)

    return types.SimpleNamespace(faults=jfaults, elastic=jelastic,
                                 integrity=jintegrity, Internal=JInternal,
                                 Hosts=JHosts)


@pytest.fixture()
def clean_faults(J):
    yield
    faults.uninstall()
    J.faults.uninstall()


def _sequence(mod, rank, host, hits=12):
    inj = mod.FaultInjector(mod.FaultPlan.from_json(json.dumps(PLAN)),
                            log_path="", rank=rank, host=host,
                            clock=lambda: 0.0)
    fired = []
    for h in range(hits):
        for site in SITES:
            spec = inj.check(site)
            fired.append(None if spec is None else (site, h, spec.mode))
    return fired, inj.injections, inj.hit_counts()


@pytest.mark.parametrize("rank,host", [("0", "hostA"), ("1", "hostB")])
def test_injection_sequence_matches_jax(J, rank, host):
    mine = _sequence(faults, rank, host)
    theirs = _sequence(J.faults, rank, host)
    assert mine == theirs
    assert any(f is not None for f in mine[0])


def test_plan_parsing_and_typos_match_jax(J):
    for mod in (faults, J.faults):
        p = mod.FaultPlan.from_json('[{"site": "crash", "step": 2}]')
        assert p.seed == 0 and p.faults[0].site == "crash"
        with pytest.raises(ValueError, match="unknown keys"):
            mod.FaultPlan.from_json('[{"site": "crash", "stpe": 2}]')
        with pytest.raises(ValueError, match="unknown fault site"):
            mod.FaultPlan.from_json('[{"site": "meteor", "step": 1}]')
        with pytest.raises(ValueError, match="needs 'step'"):
            mod.FaultPlan.from_json('[{"site": "crash"}]')


def test_backoff_delays_match_jax(J):
    for kw in ({}, {"base_s": 0.5, "factor": 3.0, "cap_s": 4.0}):
        a = faults.Backoff(rng=random.Random(9), **kw)
        b = J.faults.Backoff(rng=random.Random(9), **kw)
        assert [a.next_delay() for _ in range(12)] == \
            [b.next_delay() for _ in range(12)]
    now = {"t": 0.0}

    def runs(mod):
        now["t"] = 0.0
        slept = []

        def sleep(d):
            slept.append(d)
            now["t"] += d

        bo = mod.Backoff(base_s=1.0, cap_s=8.0, deadline_s=5.0,
                         rng=random.Random(3), clock=lambda: now["t"],
                         sleep_fn=sleep)
        oks = [bo.sleep() for _ in range(8)]
        return oks, slept

    assert runs(faults) == runs(J.faults)


def test_site_helpers_without_a_plan_are_noops(clean_faults):
    faults.uninstall()
    faults.maybe_collective_fault()
    faults.maybe_worker_fault()
    assert faults.maybe_discovery_flap({"a": 1}) == {"a": 1}
    assert faults.maybe_nonfinite() is None
    assert not faults.active()


def test_injected_collective_fault_is_a_comm_failure(clean_faults):
    faults.install(faults.FaultPlan.from_json(
        '[{"site": "collective", "step": 1}]'), log_path="")
    with pytest.raises(torch.distributed.DistBackendError) as e:
        faults.maybe_collective_fault()
    assert elastic_lib._is_comm_failure(e.value)


def test_is_comm_failure_matrix():
    dist = torch.distributed
    assert elastic_lib._is_comm_failure(HorovodInternalError("peer died"))
    assert elastic_lib._is_comm_failure(
        dist.DistBackendError("Connection closed by peer"))
    assert elastic_lib._is_comm_failure(dist.DistStoreError(
        "wait timeout after 30000ms"))
    assert elastic_lib._is_comm_failure(RuntimeError(
        "[../third_party/gloo/gloo/transport/tcp/pair.cc:534] Read error "
        "[127.0.0.1]:1234: Connection reset by peer"))
    for e in (ValueError("closed file"), ConnectionError("connection "
                                                         "reset"),
              RuntimeError("CUDA out of memory"), KeyError("socket"),
              dist.DistBackendError("invalid argument shape")):
        assert not elastic_lib._is_comm_failure(e), e


# -- states ------------------------------------------------------------------

@pytest.fixture()
def world1():
    ctx = hvd.init(device="cpu")
    try:
        yield ctx
    finally:
        hvd.shutdown()


def test_object_state_commit_restore_sync(world1):
    s = elastic.ObjectState(step=0, meta={"lr": 0.1})
    s.step = 5
    s.meta["lr"] = 0.2
    s.commit()
    s.step = 9
    s.restore()
    assert s.step == 5 and s.meta == {"lr": 0.2}
    s.sync()
    assert s.committed_items() == [("step", 5), ("meta", {"lr": 0.2})]


def _lin(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Linear(6, 4)


def _train_step(m, opt, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(8, 6, generator=g)
    opt.zero_grad()
    m(x).pow(2).mean().backward()
    opt.step()


def test_torch_state_commit_restore(world1):
    m = _lin()
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(m.parameters(),
                                                     lr=1e-2),
                                   compression="int8_ef",
                                   quantize_min_bucket_bytes=0)
    sampler = elastic.ElasticSampler(list(range(40)), shuffle=False)
    state = elastic.TorchState(m, opt, sampler=sampler, epoch=0)
    _train_step(m, opt, 1)
    sampler.record_batch(0, 4)
    state.epoch = 1
    state.commit()
    w = m.weight.detach().clone()
    st = {k: v.clone() for k, v in opt.state[m.weight].items()}
    res = {k: v.clone() for k, v in opt._ef_residual.items()}
    _train_step(m, opt, 2)
    sampler.record_batch(1, 4)
    state.epoch = 2
    assert not torch.equal(m.weight, w)
    state.restore()
    assert torch.equal(m.weight, w) and state.epoch == 1
    assert all(torch.equal(opt.state[m.weight][k], v) for k, v in st.items())
    assert opt._ef_step == 1
    assert all(torch.equal(opt._ef_residual[k], v) for k, v in res.items())
    assert sampler.processed_indices == set(range(4))
    # The snapshot is not aliased: a restored run moves again.
    _train_step(m, opt, 2)
    assert not torch.equal(m.weight, w)
    state.restore()
    assert torch.equal(m.weight, w)


class _Counting(elastic_lib.ObjectState):
    def __init__(self, **kw):
        self.counts = {"restore": 0, "sync": 0, "reset": 0}
        super().__init__(**kw)

    def restore(self):
        self.counts["restore"] += 1
        super().restore()

    def sync(self):
        self.counts["sync"] += 1
        self.save()

    def on_reset(self):
        self.counts["reset"] += 1


def _scripted(mod, internal, hosts, comm, monkeypatch):
    """``mod.run`` over a function that raises, in turn: an internal
    error, a host update, a runtime comm failure, then returns."""
    monkeypatch.setattr(mod, "_reset", lambda basics: None)
    monkeypatch.setattr(mod, "install_preemption_handler", lambda: True)
    script = [internal("peer died"), hosts(), comm, None]
    state = _Counting(step=0)
    calls = []

    @mod.run
    def train(st):
        calls.append(st.step)
        st.step += 1
        exc = script[len(calls) - 1]
        if exc is not None:
            raise exc
        return st.step

    return train(state), calls, state.counts


def test_run_matches_jax_on_scripted_failures(J, monkeypatch):
    for k in ("BASE_S", "MAX_S"):
        monkeypatch.setenv(f"HVD_TPU_ELASTIC_RESET_BACKOFF_{k}", "0")
    monkeypatch.delenv("HVD_TPU_RENDEZVOUS", raising=False)
    mine = _scripted(elastic_lib, HorovodInternalError,
                     HostsUpdatedInterrupt,
                     torch.distributed.DistBackendError(
                         "Connection closed by peer"), monkeypatch)
    theirs = _scripted(J.elastic, J.Internal, J.Hosts,
                       J.faults.XlaRuntimeError(
                           "injected: connection aborted by peer"),
                       monkeypatch)
    assert mine == theirs
    assert mine[2] == {"restore": 2, "sync": 4, "reset": 3}

    def raiser(mod):
        @mod.run
        def bad(st):
            raise ValueError("closed file")

        return bad

    for mod in (elastic_lib, J.elastic):
        with pytest.raises(ValueError, match="closed file"):
            raiser(mod)(_Counting(step=0))


def test_reset_limit(monkeypatch):
    monkeypatch.setenv("HVD_TPU_ELASTIC_RESET_LIMIT", "2")
    for k in ("BASE_S", "MAX_S"):
        monkeypatch.setenv(f"HVD_TPU_ELASTIC_RESET_BACKOFF_{k}", "0")
    monkeypatch.setattr(elastic_lib, "_reset", lambda basics: None)

    @elastic_lib.run
    def always(st):
        raise HorovodInternalError("forever broken")

    with pytest.raises(RuntimeError, match="reset limit"):
        always(_Counting(step=0))


def test_in_process_reset_rebinds_the_optimizer():
    """``_reset`` re-initializes the runtime (the same device) and
    ``TorchState.on_reset`` rebinds the optimizer's axis to the new
    world, whose process group is alive."""
    hvd.init(device="cpu")
    try:
        m = _lin()
        opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(),
                                                       lr=0.1))
        state = elastic.TorchState(m, opt)
        old = opt._axis
        elastic_lib._reset(hvd.common.basics)
        state.on_reset()
        assert opt._axis is not old
        assert opt._axis is hvd.common.basics.context().world_axis
        _train_step(m, opt, 3)
    finally:
        hvd.shutdown()


# -- in-process recovery from a failed step ----------------------------------

RECOVER_STEPS = 5


def _recover_model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.Tanh(),
                               torch.nn.Linear(16, 4))


def _fail_second_call(obj, name, calls):
    """Make ``obj.name``'s second call raise what gloo raises for a dead
    peer (a hop of the step failing, on whichever thread runs it)."""
    real = getattr(obj, name)

    def hop(*a, **kw):
        calls.append(name)
        if len(calls) == 2:
            raise torch.distributed.DistBackendError(
                "Connection closed by peer")
        return real(*a, **kw)

    return hop


def _recovered_run(kind, overlap, fault, monkeypatch):
    """RECOVER_STEPS committed steps under ``elastic.run`` in a world of
    one, with the second reduction round failing (``fault``: the
    ``collective`` site in ``synchronize()``/``step()``, or a failed hop)
    or not at all (None); returns the final state and the faults that
    fired."""
    hvd.init(device="cpu")
    calls = []
    try:
        m = _recover_model()
        if kind == "dist":
            opt = hvd.DistributedOptimizer(
                torch.optim.AdamW(m.parameters(), lr=1e-2),
                compression="int8_ef", quantize_min_bucket_bytes=0,
                fusion_threshold_bytes=256, overlap=overlap)
            state = elastic.TorchState(m, opt, step=0)
        else:
            opt = hvd.ZeroOptimizer(
                torch.optim.AdamW(m.parameters(), lr=1e-2), zero_stage=3,
                fusion_threshold_bytes=256, overlap=overlap)
            # The shards are the weights at rest: the optimizer's state
            # dict carries them.
            state = elastic.TorchState(optimizer=opt, step=0)
            fn = opt.accumulate(lambda x: m(x).pow(2).mean())
        if fault == "hop":
            if kind == "dist":
                monkeypatch.setattr(
                    hvd.ops.collectives, "quantized_allreduce",
                    _fail_second_call(hvd.ops.collectives,
                                      "quantized_allreduce", calls))
            else:
                monkeypatch.setattr(
                    opt.shard_state, "gather",
                    _fail_second_call(opt.shard_state, "gather", calls))
        elif fault == "site":
            faults.install(faults.FaultPlan.from_json(json.dumps(
                {"seed": 0, "faults": [{"site": "collective", "step": 2}]})))

        @elastic.run
        def train(st):
            while st.step < RECOVER_STEPS:
                x = torch.randn(8, 6, generator=torch.Generator()
                                .manual_seed(100 + st.step))
                if kind == "dist":
                    opt.zero_grad()
                    m(x).pow(2).mean().backward()
                else:
                    fn(x)
                opt.step()
                st.step += 1
                st.commit()

        train(state)
        fired = len(faults.injector().injections) \
            if faults.injector() is not None else 0
        sd = opt.state_dict()
        out = {"state": sd, "step": state.step,
               "restores": fired + (len(calls) >= 2)}
        if kind == "dist":
            out["params"] = [p.detach().clone() for p in m.parameters()]
        return out
    finally:
        faults.uninstall()
        hvd.shutdown()


def _same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_tree(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("kind", ["dist", "zero3"])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("fault", ["site", "hop"])
def test_in_process_recovery_from_a_failed_step(kind, overlap, fault,
                                                monkeypatch):
    """A reduction round that fails mid-step (after backprop launched
    its buckets, or under a stage-3 prefetch) is rolled back in process:
    the restore drops the step in progress (its buckets, counters,
    guard round, prefetch and latched worker), the run finishes every
    step, and the final weights, AdamW state and int8_ef residuals equal
    an uninterrupted run's, bitwise."""
    for k in ("BASE_S", "MAX_S"):
        monkeypatch.setenv(f"HVD_TPU_ELASTIC_RESET_BACKOFF_{k}", "0")
    monkeypatch.delenv("HVD_TPU_RENDEZVOUS", raising=False)
    monkeypatch.setattr(elastic_lib, "install_preemption_handler",
                        lambda: True)
    clean = _recovered_run(kind, overlap, None, monkeypatch)
    got = _recovered_run(kind, overlap, fault, monkeypatch)
    assert got["restores"] == 1
    assert got["step"] == clean["step"] == RECOVER_STEPS
    assert _same_tree(got["state"], clean["state"])
    assert _same_tree(got.get("params"), clean.get("params"))


# -- save_state / restore_state ---------------------------------------------

def test_save_restore_state_walks_back(world1, tmp_path, clean_faults):
    """Commits at steps 1 and 2, each persisted; the
    ``checkpoint_corrupt`` site flips a bit of step 2's payload as it
    is written, so ``restore_state`` walks back to step 1 and loads
    step 1's weights, AdamW state, residual and plain values bitwise."""
    d = str(tmp_path / "state")
    m = _lin()
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(m.parameters(),
                                                     lr=1e-2),
                                   compression="int8_ef",
                                   quantize_min_bucket_bytes=0)
    state = elastic.TorchState(m, opt, step=0, tag="run")
    snaps = {}
    for step in (1, 2):
        _train_step(m, opt, step)
        state.step = step
        state.commit()
        if step == 2:
            faults.install(faults.FaultPlan.from_json(
                '[{"site": "checkpoint_corrupt", "step": 1}]'),
                log_path="")
        ckpt.save_state(state, d, step)
        snaps[step] = (m.weight.detach().clone(),
                       {k: v.clone() for k, v in
                        opt.state[m.weight].items()},
                       opt._ef_residual[0].clone())
    m2 = _lin(seed=5)
    opt2 = hvd.DistributedOptimizer(torch.optim.AdamW(m2.parameters(),
                                                      lr=1e-2),
                                    compression="int8_ef",
                                    quantize_min_bucket_bytes=0)
    s2 = elastic.TorchState(m2, opt2, step=0, tag="")
    before = faults.recovery_stats()["checkpoint_corruptions"]
    assert ckpt.restore_state(s2, d) == 1
    assert faults.recovery_stats()["checkpoint_corruptions"] == before + 1
    w, st, res = snaps[1]
    assert s2.step == 1 and s2.tag == "run"
    assert torch.equal(m2.weight, w)
    assert all(torch.equal(opt2.state[m2.weight][k], v)
               for k, v in st.items())
    assert torch.equal(opt2._ef_residual[0], res) and opt2._ef_step == 1
    # The committed snapshot is what was restored.
    s2.restore()
    assert torch.equal(m2.weight, w)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_state(s2, str(tmp_path / "empty"))


# -- chaos hooks ---------------------------------------------------------------

def test_chaos_poison_and_perturb_match_jax(J, clean_faults):
    plan = json.dumps({"seed": 5, "faults": [
        {"site": "nonfinite", "step": 1, "mode": "inf"},
        {"site": "nonfinite", "step": 2},
        {"site": "diverge", "step": 1, "target": "0", "scale": 0.5}]})
    faults.install(faults.FaultPlan.from_json(plan), log_path="")
    J.faults.install(J.faults.FaultPlan.from_json(plan), log_path="")
    rng = np.random.default_rng(1)
    tree = {"b": rng.standard_normal((3,)).astype(np.float32),
            "a": np.arange(4, dtype=np.int32),
            "w": rng.standard_normal((2, 3)).astype(np.float32)}
    ttree = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    import jax.numpy as jnp

    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    for _ in range(2):
        got = integrity.chaos_poison(ttree)
        want = J.integrity.chaos_poison(jtree)
        for k in tree:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    assert torch.equal(ttree["b"], torch.from_numpy(tree["b"]))
    stacked = {"w": rng.standard_normal((3, 4, 2)).astype(np.float32)}
    got = integrity.chaos_perturb({"w": torch.from_numpy(stacked["w"])})
    want = J.integrity.chaos_perturb({"w": jnp.asarray(stacked["w"])})
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    assert not np.array_equal(got["w"].numpy()[0], stacked["w"][0])
    np.testing.assert_array_equal(got["w"].numpy()[1:], stacked["w"][1:])


# -- two gloo ranks -----------------------------------------------------------

def _sync_worker(rank: int, out_path: str) -> None:
    """TorchState.sync in a world of 2: rank 0's weights and AdamW state,
    each rank's own residual."""
    hvd.init(device="cpu")
    m = _lin(seed=rank)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(m.parameters(),
                                                     lr=1e-2),
                                   compression="int8_ef",
                                   quantize_min_bucket_bytes=0)
    _train_step(m, opt, 7 + rank)
    res = opt._ef_residual[0].clone()
    state = elastic.TorchState(m, opt, step=3 + rank)
    state.sync()
    out = {"w": m.weight.detach(), "exp_avg": opt.state[m.weight]["exp_avg"],
           "res": opt._ef_residual[0], "res_before": res,
           "step": torch.tensor(state.step)}
    hvd.shutdown()
    torch.save(out, out_path)


def test_torch_state_sync_keeps_each_ranks_residual(tmp_path):
    run_ranks(__file__, lambda r: ("--sync-worker", r,
                                   tmp_path / f"r{r}.pt"), 2)
    r0, r1 = (torch.load(tmp_path / f"r{r}.pt") for r in (0, 1))
    assert torch.equal(r0["w"], r1["w"])
    assert torch.equal(r0["exp_avg"], r1["exp_avg"])
    assert int(r1["step"]) == 3
    for r in (r0, r1):
        assert torch.equal(r["res"], r["res_before"])
    assert not torch.equal(r0["res"], r1["res"])


def _peer_death_worker(rank: int, out_path: str) -> None:
    """Rank 1 exits before the all_reduce rank 0 is waiting in."""
    hvd.init(device="cpu")
    hvd.barrier()
    if rank == 1:
        os._exit(0)
    out = {}
    try:
        t = torch.ones(1 << 20)
        torch.distributed.all_reduce(t)
        out["raised"] = None
    except Exception as e:  # noqa: BLE001 — classified below
        out = {"raised": type(e).__name__, "module": type(e).__module__,
               "message": str(e)[:500],
               "comm_failure": elastic_lib._is_comm_failure(e)}
    with open(out_path, "w") as f:
        json.dump(out, f)
    os._exit(0)


def test_is_comm_failure_on_a_real_gloo_peer_death(tmp_path):
    env = rank_env(2, HVD_TPU_ELASTIC="1",
                   HVD_TPU_STALL_CHECK_TIME_SECONDS="30")
    out = tmp_path / "rank0.json"
    run_procs({f"rank {r}": ([sys.executable, __file__, "--death-worker",
                              str(r), str(out)],
                             dict(env, HVD_TPU_PROC_ID=str(r)))
               for r in (0, 1)}, timeout=120)
    got = json.loads(out.read_text())
    assert got["raised"] is not None, got
    assert got["comm_failure"], got


if __name__ == "__main__" and sys.argv[1:2] == ["--sync-worker"]:
    _sync_worker(int(sys.argv[2]), sys.argv[3])
if __name__ == "__main__" and sys.argv[1:2] == ["--death-worker"]:
    _peer_death_worker(int(sys.argv[2]), sys.argv[3])
