"""The port's autotuner (``common/autotune.py``), ``AutotunedStepper`` and
the live re-planning of its optimizers, against the JAX package's, after
the reference tests of ``tests/test_autotune.py``.

* The search: ``GaussianProcess.fit/predict`` and
  ``expected_improvement`` on seeded inputs equal the JAX module's to
  1e-12; both tuners, fed the same scripted ``(bytes, seconds)``
  sequence (the seconds a fixed pseudo-random function of the point
  tried, so no two points score alike), give the same ``TunedPoint``
  after every call, converge at the same call and write the same CSV
  after its ``unix_time`` column: the threshold alone, the five historic
  axes, the accumulation/remat/shard axes with the gate true, false and
  absent (the default gate on a comm-bound and a compute-bound
  ``hvd_tpu_step_phase_seconds`` snapshot), and the three wire axes;
  their ``hvd_tpu_autotune_*`` families, each in a fresh registry, are
  equal.
* The wiring: ``init(autotune=True)`` builds the context's tuner and
  ``ctx.fusion_threshold()`` (and a ``DistributedOptimizer`` made
  without a threshold) follows it; the eager engine of a world of one
  feeds it from a grouped allreduce and the next grouped call plans at
  the moved threshold.
* ``AutotunedStepper`` in one process: the same build calls and
  ``rebuilds`` as the JAX stepper for every signature form, with a tuner
  that replaces the measured seconds by the script; in two threads over
  the controller's in-memory transport, the JAX stepper's points.
* A gloo world of 2 (this file run as ``--replan-worker RANK OUT``),
  ``gpt_tiny`` with AdamW under the stepper: both ranks make the same
  build calls, the exchange rounds stop after ``:done``; a threshold
  moved by the stepper leaves losses and parameters bitwise those of a
  fixed-threshold run (compression none, the guard under
  ``scale_backoff`` with its loss scale kept across a move, and ZeRO
  stage 1); under ``int8_ef`` every leaf's residual is bitwise the same
  across each re-plan and each step issues exactly the new plan's
  buckets; a re-plan with buckets in flight raises. The toy MLP on the
  int8_ef optimizer's bf16 wire, re-planned at the same steps as a JAX
  ``DistributedOptimizer`` rebuilt there, stays within the 1e-6 that
  ``test_torch_port_reduce.py`` holds that wire to.
"""

import json
import sys
import threading
import types
import zlib

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import autotune as P_at
from horovod_tpu_torch.common import basics, fusion
from horovod_tpu_torch.common import metrics as P_metrics
from horovod_tpu_torch.ops import eager
from test_torch_port_worlds import run_ranks

GP_TOL = 1e-12
OPT_TOL = 1e-6          # int8_ef on the bf16 wire vs the JAX optimizer
GRAD_BYTES = 1 << 20
MB = 1 << 20
# The thresholds of the replan runs: the stepper's candidates.
REPLAN_CANDIDATES = (1024, 4096, 64 * MB)
REPLAN_CALLS = 8
MLP_SCHEDULE = (64, 1 << 20, 16, 64)   # bytes: 3, 1, 7 and 3 buckets


@pytest.fixture(scope="module")
def J():
    from horovod_tpu.common import autotune as jat
    from horovod_tpu.common import metrics as jmetrics
    from horovod_tpu.common.controller import Controller, InMemoryTransport
    from horovod_tpu.optim import AutotunedStepper

    return types.SimpleNamespace(at=jat, metrics=jmetrics,
                                 Stepper=AutotunedStepper,
                                 Controller=Controller,
                                 Transport=InMemoryTransport)


def _seconds(point) -> float:
    """The scripted step time of a tuned point (a pure function of it)."""
    return 0.5 + zlib.crc32(repr(tuple(point)).encode()) % 9973 / 9973


# -- the search ------------------------------------------------------------------

def test_gp_and_ei_match_jax(J):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((7, 4))
    y = rng.standard_normal(7)
    grid = rng.standard_normal((30, 4))
    out = []
    for mod in (J.at, P_at):
        gp = mod.GaussianProcess(length_scale=1.3)
        gp.fit(x, y)
        mu, var = gp.predict(grid)
        out.append((mu, var, mod.expected_improvement(mu, var, y.max())))
    for a, b in zip(*out):
        np.testing.assert_allclose(b, a, rtol=0, atol=GP_TOL)


_CASES = {
    "threshold": dict(warmup_samples=1, steps_per_sample=2),
    "five_axes": dict(candidates_bytes=(MB, 16 * MB), warmup_samples=0,
                      steps_per_sample=1, tune_hierarchical=True,
                      tune_overlap=True, tune_compression=True,
                      tune_route=True),
    "mfu_gate_true": dict(candidates_bytes=(MB, 4 * MB), warmup_samples=0,
                          steps_per_sample=1, tune_accum=True,
                          accum_candidates=(1, 2, 4), tune_remat=True,
                          tune_shard=True, gate=True),
    "mfu_gate_false": dict(candidates_bytes=(MB, 4 * MB), warmup_samples=0,
                           steps_per_sample=1, tune_accum=True,
                           accum_candidates=(1, 2, 4), tune_remat=True,
                           tune_shard=True, gate=False),
    "mfu_default_comm": dict(candidates_bytes=(MB, 4 * MB),
                             warmup_samples=0, steps_per_sample=1,
                             tune_accum=True, tune_remat=True,
                             phases={"grad": 1.0, "comm": 1.0}),
    "mfu_default_compute": dict(candidates_bytes=(MB, 4 * MB),
                                warmup_samples=0, steps_per_sample=1,
                                tune_accum=True, tune_remat=True,
                                phases={"grad": 1.0, "comm": 0.05}),
    "wires": dict(candidates_bytes=(MB, 2 * MB), warmup_samples=1,
                  steps_per_sample=1, tune_moe_wire=True, tune_pp_wire=True,
                  tune_seq_wire=True),
}


def _phase_snapshot(phases):
    return {"hvd_tpu_step_phase_seconds": {"samples": [
        {"labels": {"phase": k}, "value": {"count": 3, "sum": v}}
        for k, v in phases.items()]}}


def _fresh_metrics(monkeypatch, mod, metrics_mod):
    """Rebind every metric family of the autotune module ``mod`` to a
    fresh registry; returns it."""
    reg = metrics_mod.MetricsRegistry(enabled=True)
    for name in dir(mod):
        fam = getattr(mod, name)
        if name.startswith("_M_"):
            make = reg.counter if "samples" in fam.name else reg.gauge
            monkeypatch.setattr(mod, name, make(fam.name, fam.help,
                                                fam.labelnames))
    return reg


def _drive(mod, kw, log_file, max_calls=600):
    """Feed the tuner the scripted seconds until it converges; returns
    (the point and done flag after every call, the tuner)."""
    kw = dict(kw)
    gate = kw.pop("gate", None)
    kw.pop("phases", None)
    tuner = mod.Autotuner(log_file=str(log_file), accum_gate=(
        None if gate is None else (lambda: gate)), **kw)
    tuner.initial_space = len(tuner._space)
    seen = []
    for _ in range(max_calls):
        pt = tuner.feed_full(GRAD_BYTES, _seconds(tuner.current_full))
        seen.append((tuple(pt), tuner.done))
        if tuner.done:
            break
    return seen, tuner


@pytest.mark.parametrize("case", sorted(_CASES))
def test_autotuner_matches_jax(J, case, tmp_path, monkeypatch):
    kw = _CASES[case]
    if "phases" in kw:
        snap = _phase_snapshot(kw["phases"])
        monkeypatch.setattr(J.at.metrics_lib, "snapshot", lambda: snap)
        monkeypatch.setattr(P_at.metrics_lib, "snapshot", lambda: snap)
    regs = [_fresh_metrics(monkeypatch, J.at, J.metrics),
            _fresh_metrics(monkeypatch, P_at, P_metrics)]
    jseen, jt = _drive(J.at, kw, tmp_path / "jax.csv")
    pseen, pt = _drive(P_at, kw, tmp_path / "port.csv")
    assert pseen == jseen
    assert pt.done and len(pt._space) == len(jt._space)
    pruned = case in ("mfu_gate_false", "mfu_default_compute")
    assert (len(pt._space) < pt.initial_space) == pruned
    rows = []
    for path in ("jax.csv", "port.csv"):
        lines = (tmp_path / path).read_text().splitlines()
        rows.append([lines[0]] + [ln.split(",", 1)[1] for ln in lines[1:]])
    assert rows[1] == rows[0] and len(rows[0]) > 2
    snaps = [{k: v for k, v in reg.snapshot().items()
              if k.startswith("hvd_tpu_autotune_")} for reg in regs]
    assert snaps[1] == snaps[0] and len(snaps[0]) == 13


def test_default_accum_gate_without_evidence(monkeypatch):
    monkeypatch.setattr(P_at.metrics_lib, "snapshot", lambda: {})
    assert P_at._phase_bound_accum_gate() is True


# -- the context and the eager engine ----------------------------------------------

def test_context_constructs_autotuner_and_threshold_tracks_it():
    hvd.shutdown()
    try:
        ctx = hvd.init(device="cpu", autotune=True,
                       autotune_warmup_samples=0,
                       autotune_steps_per_sample=1)
        assert ctx.autotuner is not None
        assert ctx.engine.autotuner is ctx.autotuner
        assert ctx.fusion_threshold() == ctx.autotuner.current
        before = ctx.autotuner.current
        m = torch.nn.Linear(4, 3)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(),
                                                       lr=0.1))
        assert opt.fusion_threshold == before
        ctx.autotuner.record(1e6, 0.001)
        assert ctx.autotuner.ready()
        ctx.autotuner.suggest()
        # With every other candidate untried, exploration moves the knob.
        assert ctx.fusion_threshold() == ctx.autotuner.current
        assert ctx.autotuner.current != before or ctx.autotuner.done
        for h in opt._dist_hooks:
            h.remove()
        opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(),
                                                       lr=0.1))
        assert opt.fusion_threshold == ctx.autotuner.current
    finally:
        hvd.shutdown()


def test_engine_feeds_autotuner_from_grouped_allreduce(monkeypatch):
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        tuner = P_at.Autotuner(candidates_bytes=[1024, 64 * MB],
                               warmup_samples=0, steps_per_sample=1)
        engine = basics.context().engine
        monkeypatch.setattr(engine, "autotuner", tuner)
        planned = []
        real = fusion.plan_fusion

        def spy(leaves, threshold, *a, **k):
            planned.append(threshold)
            return real(leaves, threshold, *a, **k)

        monkeypatch.setattr(eager.fusion_lib, "plan_fusion", spy)
        xs = [torch.ones(8, 64), torch.full((8, 96), 2.0)]
        out = hvd.grouped_allreduce(xs, name="tune_me")
        assert all(torch.equal(o, x) for o, x in zip(out, xs))
        # One sample (steps_per_sample=1), suggest() ran and moved.
        assert len(tuner._samples) == 1 and planned == [64 * MB]
        assert tuner.current == 1024
        hvd.grouped_allreduce(xs, name="tune_me")
        assert planned == [64 * MB, 1024]
    finally:
        hvd.shutdown()


# -- the stepper ---------------------------------------------------------------

def _scripted(mod):
    """A tuner whose recorded seconds are the script's, not the clock's."""
    class Scripted(mod.Autotuner):
        def record(self, nbytes, seconds):
            super().record(nbytes, _seconds(self.current_full))
    return Scripted


_FORMS = {
    "threshold": dict(),
    "hierarchical": dict(tune_hierarchical=True),
    "overlap": dict(tune_hierarchical=True, tune_overlap=True),
    "compression": dict(tune_overlap=True, tune_compression=True),
    "route": dict(tune_route=True),
    "point_accum": dict(tune_accum=True, accum_candidates=(1, 2),
                        accum_gate=lambda: True),
    "point_wires": dict(tune_moe_wire=True, tune_pp_wire=True),
}


def _stepper_run(mod, Stepper, kw, calls=24, controller=None, sink=None):
    tuner = _scripted(mod)(candidates_bytes=[1024, 2048, 4096],
                           warmup_samples=1, steps_per_sample=1, **kw)
    seen = [] if sink is None else sink

    def build(*args):
        seen.append(tuple(tuple(a) if isinstance(a, tuple) else a
                          for a in args))
        return lambda x: x + 1

    stepper = Stepper(build, grad_bytes=1000, tuner=tuner, block=False,
                      controller=controller)
    outs = [stepper(i) for i in range(calls)]
    assert outs == [i + 1 for i in range(calls)]
    return seen, stepper.rebuilds, tuner.done


@pytest.mark.parametrize("form", sorted(_FORMS))
def test_stepper_build_calls_match_jax(J, form):
    want = _stepper_run(J.at, J.Stepper, _FORMS[form])
    got = _stepper_run(P_at, hvd.AutotunedStepper, _FORMS[form])
    assert got == want
    assert got[1] >= 1


def _threaded(mod, Stepper, Controller, Transport, kw, calls):
    transport = Transport()
    results = {}
    barrier = threading.Barrier(2)

    def rank(r):
        seen = []
        c = Controller(r, 2, transport, timeout_s=20.0)
        barrier.wait()
        results[r] = _stepper_run(mod, Stepper, kw, calls, controller=c,
                                  sink=seen)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return results


@pytest.mark.parametrize("form", ["threshold", "point_accum"])
def test_stepper_two_threads_match_jax(J, form):
    from horovod_tpu_torch.common.controller import (Controller,
                                                     InMemoryTransport)

    want = _threaded(J.at, J.Stepper, J.Controller, J.Transport,
                     _FORMS[form], 16)
    got = _threaded(P_at, hvd.AutotunedStepper, Controller,
                    InMemoryTransport, _FORMS[form], 16)
    assert got[0][0] == got[1][0] == want[0][0] == want[1][0]
    assert got[0][1] == want[0][1] >= 1


def test_stepper_needs_a_tuner():
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        with pytest.raises(ValueError, match="autotuner not enabled"):
            hvd.AutotunedStepper(lambda t: None, grad_bytes=1)
    finally:
        hvd.shutdown()


# -- re-planning in one process ---------------------------------------------------

def _one_process_run(schedule, **kw):
    """gpt_tiny AdamW, re-planned to ``schedule[i]`` before step i."""
    m, gpt_mod = _tiny()
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(m.parameters(),
                                                     lr=1e-3),
                                   fusion_threshold_bytes=schedule[0], **kw)
    losses = []
    for s, threshold in enumerate(schedule):
        opt.replan(threshold)
        x = _tokens(s, 0)
        step = opt.accumulate(
            lambda t: gpt_mod.next_token_loss(m(t[:, :-1]), t[:, 1:]))
        losses.append(step(x).item())
        opt.step()
    if kw.get("zero_stage") == 3:
        opt.gather_params()
    else:
        opt.zero_grad()
    return losses, [p.detach().clone() for p in m.parameters()], opt


@pytest.mark.parametrize("stage", [2, 3])
def test_zero_replan_is_bitwise_a_fixed_threshold_run(stage):
    """Stages 2 and 3 (accumulate's exact reduce-scatter, stage 3's
    freed parameters gathered for the re-slice and freed again)."""
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        moving = (1024, 64 * MB, 4096, 1024)
        a = _one_process_run((1024,) * len(moving), zero_stage=stage)
        b = _one_process_run(moving, zero_stage=stage)
        assert a[0] == b[0]
        assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
        assert len(b[2].shard_state.plan.buckets) > 1
    finally:
        hvd.shutdown()


def test_state_dict_saved_before_a_move_loads_after():
    """An int8_ef state saved at one threshold loads into the optimizer
    re-planned to another: each leaf's residual lands bitwise; a leaf
    outside the new plan's int8 buckets is kept, not dropped."""
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        _, _, opt = _one_process_run(
            (1024, 1024), compression="int8_ef",
            quantize_min_bucket_bytes=4096)
        saved = opt.state_dict()
        before = opt._ef_by_leaf()
        assert before and saved["ef_state"]["fusion_threshold"] == 1024
        opt.replan(64 * MB)
        opt._ef_residual, opt._ef_parked = {}, {}
        opt.load_state_dict(saved)
        after = opt._ef_by_leaf()
        assert len(opt._dist_plan.buckets) == 1
        assert all(torch.equal(after[i], r) for i, r in before.items())
        opt.replan(16)      # the small leaves' buckets fall below 4096 B
        assert opt._ef_residual and opt._ef_parked
        kept = opt.state_dict()
        assert set(kept["ef_state"]["parked"]) == set(opt._ef_parked)
        opt.replan(1024)
        opt.load_state_dict(kept)
        assert all(torch.equal(opt._ef_by_leaf()[i], r)
                   for i, r in before.items())
        for h in opt._dist_hooks:
            h.remove()
    finally:
        hvd.shutdown()


# -- re-planning in a gloo world of 2 ----------------------------------------------

def _tokens(step, rank):
    return torch.randint(0, 128, (2, 17),
                         generator=torch.Generator().manual_seed(
                             100 * step + rank))


def _tiny():
    from horovod_tpu_torch.models import gpt as gpt_mod

    m = gpt_mod.gpt_tiny()
    m.init_weights(torch.Generator().manual_seed(0))
    return m, gpt_mod


def _train(rank, case, moving):
    """``REPLAN_CALLS`` steps of gpt_tiny under the stepper (``moving``)
    or at the stepper's first threshold (fixed); returns the record."""
    m, gpt_mod = _tiny()
    kw = {"none": {}, "int8_ef": {"compression": "int8_ef",
                                  "quantize_min_bucket_bytes": 4096},
          "guard": {"nonfinite_policy": "scale_backoff"},
          "zero1": {"zero_stage": 1}}[case]
    tuner = _scripted(P_at)(candidates_bytes=REPLAN_CANDIDATES,
                            warmup_samples=0, steps_per_sample=1)
    first = tuner.current
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(m.parameters(), lr=1e-3),
        fusion_threshold_bytes=first, **kw)
    rec = {"builds": [], "leaf_checks": 0, "leaf_equal": True,
           "scales": [], "issued_ok": True, "losses": []}

    def step(s):
        x = _tokens(s, rank)
        loss = gpt_mod.next_token_loss(m(x[:, :-1]), x[:, 1:])
        if case == "guard" and s == 1 and rank == 1:
            loss = loss * float("nan")      # one skipped step, scale halves
        opt.zero_grad()
        before = getattr(opt, "bucket_allreduces", 0)
        loss.backward()
        opt.step()
        if case == "int8_ef":
            rec["issued_ok"] &= (opt.bucket_allreduces - before
                                 == len(opt._dist_plan.buckets))
        return loss.detach()

    def build(threshold):
        rec["builds"].append(threshold)
        if len(rec["builds"]) > 1:
            scale = hvd.current_loss_scale(opt) if case == "guard" else None
            leaves = opt._ef_by_leaf() if case == "int8_ef" else {}
            opt.replan(threshold)
            if case == "int8_ef":
                after = opt._ef_by_leaf()
                rec["leaf_checks"] += len(leaves)
                rec["leaf_equal"] &= all(torch.equal(after[i], r)
                                         for i, r in leaves.items())
            if case == "guard":
                rec["scales"].append([scale, hvd.current_loss_scale(opt)])
        return step

    if moving:
        ctx = basics.context()
        calls = []
        exchange = ctx.controller.exchange

        def counted(tag, value):
            calls.append(stepper._calls)
            return exchange(tag, value)

        ctx.controller.exchange = counted
        stepper = hvd.AutotunedStepper(build, grad_bytes=1000, tuner=tuner)
        rec["done_at"] = None
        for s in range(REPLAN_CALLS):
            rec["losses"].append(stepper(s).item())
            if stepper._tuner_done and rec["done_at"] is None:
                rec["done_at"] = stepper._calls
        ctx.controller.exchange = exchange
        rec["exchanges"] = calls
        rec["rebuilds"] = stepper.rebuilds
        rec["tuner_point"] = [tuner.current, tuner.done]
    else:
        for s in range(REPLAN_CALLS):
            rec["losses"].append(step(s).item())
    rec["losses"] = [float(v).hex() for v in rec["losses"]]
    if case == "zero1":
        rec["zero_buckets"] = len(opt.shard_state.plan.buckets)
    else:
        for h in opt._dist_hooks:
            h.remove()
    rec["params"] = {n: p.detach().numpy().copy()
                     for n, p in m.named_parameters()}
    return rec


def _mlp_moves(rank):
    """The toy MLP on the int8_ef bf16 wire, re-planned before each step
    to ``MLP_SCHEDULE``'s threshold; the parameters after each step."""
    from test_torch_port_reduce import _mlp, _mlp_loss, _opt_data

    od = _opt_data()
    m = _mlp(od["params"])
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=0.1), compression="int8_ef",
        fusion_threshold_bytes=MLP_SCHEDULE[0],
        quantize_min_bucket_bytes=1 << 30,
        named_parameters=m.named_parameters())
    out = {}
    for s, threshold in enumerate(MLP_SCHEDULE[:len(od["x"])]):
        opt.replan(threshold)
        out[f"buckets/{s}"] = len(opt._dist_plan.buckets)
        opt.zero_grad()
        _mlp_loss(m, od["x"][s, rank], od["y"][s, rank]).backward()
        opt.step()
        for k, v in m.state_dict().items():
            out[f"mlp/{s}/{k}"] = v.numpy().copy()
    for h in opt._dist_hooks:
        h.remove()
    return out


def _replan_worker(rank: int, out_path: str) -> None:
    hvd.init(device="cpu")
    assert hvd.size() == 2
    out = {}
    for case in ("none", "int8_ef", "guard", "zero1"):
        for moving in (True, False):
            rec = _train(rank, case, moving)
            label = f"{case}/{'moving' if moving else 'fixed'}"
            for k, v in rec.pop("params").items():
                out[f"{label}/param/{k}"] = v
            out[f"{label}/rec"] = np.array(json.dumps(rec))
    m, gpt_mod = _tiny()
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(m.parameters()),
                                   compression="int8_ef")
    x = _tokens(0, rank)
    gpt_mod.next_token_loss(m(x[:, :-1]), x[:, 1:]).backward()
    try:
        opt.replan(1024)
        out["inflight_raised"] = np.array(False)
    except RuntimeError:
        out["inflight_raised"] = np.array(True)
    opt.step()
    opt.replan(1024)            # between two steps: fine
    out.update(_mlp_moves(rank))
    hvd.shutdown()
    np.savez(out_path, **out)


_WORLD = []


@pytest.fixture()
def world2(tmp_path_factory):
    if not _WORLD:
        out = tmp_path_factory.mktemp("replan")
        run_ranks(__file__, lambda r: ("--replan-worker", r,
                                       out / f"rank{r}.npz"), 2, timeout=240)
        _WORLD.extend(dict(np.load(out / f"rank{r}.npz"))
                      for r in range(2))
    return _WORLD


def _rec(rank, label):
    return json.loads(str(rank[f"{label}/rec"]))


def test_two_ranks_adopt_the_same_points_and_stop_after_done(world2):
    for case in ("none", "int8_ef", "guard", "zero1"):
        recs = [_rec(r, f"{case}/moving") for r in world2]
        assert recs[0]["builds"] == recs[1]["builds"], case
        assert len(set(recs[0]["builds"])) == len(REPLAN_CANDIDATES)
        assert recs[0]["rebuilds"] == len(recs[0]["builds"]) - 1 >= 2
        for rec in recs:
            # Rank 1's tuner mirrors the point rank 0 decided.
            assert rec["tuner_point"] == [rec["builds"][-1], True], case
            assert rec["done_at"] is not None, case
            assert rec["exchanges"] and max(rec["exchanges"]) \
                <= rec["done_at"], rec


@pytest.mark.parametrize("case", ["none", "guard", "zero1"])
def test_moves_are_bitwise_a_fixed_threshold_run(world2, case):
    for r, rank in enumerate(world2):
        moving, fixed = _rec(rank, f"{case}/moving"), _rec(rank,
                                                           f"{case}/fixed")
        assert moving["losses"] == fixed["losses"], (case, r)
        names = [k.split("/param/")[1] for k in rank
                 if k.startswith(f"{case}/fixed/param/")]
        assert names
        for n in names:
            np.testing.assert_array_equal(
                rank[f"{case}/moving/param/{n}"],
                rank[f"{case}/fixed/param/{n}"], err_msg=f"{case} {r} {n}")


def test_guard_keeps_its_loss_scale_across_moves(world2):
    for rank in world2:
        rec = _rec(rank, "guard/moving")
        assert rec["scales"] and all(a == b for a, b in rec["scales"])
        # The NaN step (the second) halved the initial scale, which the
        # moves after it carry.
        assert [a for a, _ in rec["scales"][:2]] == [2.0 ** 15, 2.0 ** 14]


def test_int8_ef_residual_moves_leaf_by_leaf(world2):
    for rank in world2:
        rec = _rec(rank, "int8_ef/moving")
        assert rec["leaf_checks"] > 0 and rec["leaf_equal"]
        assert rec["issued_ok"]
        assert all(np.isfinite(float.fromhex(v)) for v in rec["losses"])


def test_replan_with_buckets_in_flight_raises(world2):
    assert all(bool(rank["inflight_raised"]) for rank in world2)


def test_int8_ef_bf16_wire_moves_match_jax_rebuilt_optimizer(J, world2):
    """JAX: ``DistributedOptimizer(fusion_threshold_bytes=T)`` rebuilt
    at each step of the same schedule, its state carried."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, PartitionSpec as P

    import horovod_tpu as hvd_jax
    from horovod_tpu.ops import collectives as jC
    from test_torch_port_reduce import _opt_data

    od = _opt_data()
    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))

    def loss(p, x, y):
        h = jnp.tanh(x @ p["0.weight"].T + p["0.bias"])
        return ((h @ p["2.weight"].T + p["2.bias"] - y) ** 2).mean()

    params = {k: jnp.asarray(v) for k, v in od["params"].items()}
    state = None
    for s, threshold in enumerate(MLP_SCHEDULE[:len(od["x"])]):
        tx = hvd_jax.DistributedOptimizer(
            optax.sgd(0.1), axis_name="hvd", compression="int8_ef",
            fusion_threshold_bytes=threshold,
            quantize_min_bucket_bytes=1 << 30)
        state = tx.init(params) if state is None else state

        def body(p, st, xb, yb, tx=tx):
            p = jC.to_local(p, "hvd")
            g = jax.grad(lambda q: loss(q, xb[0], yb[0]))(p)
            upd, st = tx.update(g, st, p)
            return optax.apply_updates(p, upd), st

        step = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P(), P(), P("hvd"), P("hvd")),
            out_specs=(P(), P()), check_vma=False))
        params, state = step(params, state, od["x"][s], od["y"][s])
        for r, rank in enumerate(world2):
            assert int(rank[f"buckets/{s}"]) == len(fusion.plan_fusion(
                [torch.from_numpy(np.asarray(v)) for v in
                 od["params"].values()], threshold,
                order=fusion.ORDER_REVERSE).buckets)
            for name, ref in params.items():
                np.testing.assert_allclose(
                    rank[f"mlp/{s}/{name}"], np.asarray(ref), rtol=OPT_TOL,
                    atol=OPT_TOL, err_msg=f"step {s} rank {r} {name}")


if __name__ == "__main__" and sys.argv[1:2] == ["--replan-worker"]:
    _replan_worker(int(sys.argv[2]), sys.argv[3])
