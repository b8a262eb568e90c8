"""The port's integrity guard (``horovod_tpu_torch/common/integrity.py``
and ``DistributedOptimizer(nonfinite_policy=)``) against the JAX
package's (``horovod_tpu/common/integrity.py``), after the reference
tests of ``tests/test_integrity.py``.

* One process (``init(device="cpu")``) against the JAX
  ``DistributedOptimizer(optax.sgd, nonfinite_policy=)`` under
  ``shard_map`` on a one-device mesh, fed the same gradients (a loss
  ``(w * G).sum()`` has gradient ``G`` exactly): guard counters, the loss
  scale and ``last_ok`` exact after every step, parameters to 1e-6
  (NaN where JAX has NaN).
* ``scale_backoff``'s unscale (K1's plain version with ``1 / loss_scale``
  rounded to the bucket's dtype) bitwise against JAX's ``g *
  inv.astype(g.dtype)`` in fp32 and bf16.
* Fingerprints to 1e-6 relative of JAX's; the digest moves with a
  perturbation and not without.
* ``DivergenceDetector`` over the controller's ``exchange`` (three ranks
  on threads over ``InMemoryTransport``) names the same offenders as the
  JAX detector over its own controller.
* Two gloo ranks (this file run as ``--guard-worker RANK N OUT``):
  ``skip_step`` with a NaN on rank 1 against the JAX optimizer on a
  two-device mesh (1e-6, counters exact); ``int8_ef`` + ``skip_step``
  leaves the residual and the rounding step bitwise unchanged across the
  skip and continues bitwise as a run that never saw the bad step;
  ``divergence_guard(policy="resync")`` heals a perturbed rank.

JAX is imported only inside the ``J`` fixture: the worker processes
import this file and must not pay for it.
"""

import itertools
import sys
import threading
import types

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import controller as port_controller
from horovod_tpu_torch.common import integrity
from horovod_tpu_torch.common import metrics as metrics_lib
from horovod_tpu_torch.ops import kernels
from test_torch_port_worlds import run_ranks

PARAM_TOL = 1e-6        # parameters after a guarded run, vs JAX
FP_RTOL = 1e-6          # fingerprints vs JAX, relative to each entry
SHAPE = (4, 3)
LR = 0.1
EF_SHAPE = (64, 8)      # one int8 bucket at quantize_min_bucket_bytes=0
_RUNS = itertools.count()   # a metric stream name per run (observe_guard)


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp
    import optax

    import horovod_tpu as hvd_jax
    from horovod_tpu.common import controller as jcontroller
    from horovod_tpu.common import integrity as jintegrity
    from horovod_tpu.common.exceptions import DivergenceError

    return types.SimpleNamespace(jax=jax, jnp=jnp, optax=optax, hvd=hvd_jax,
                                 integrity=jintegrity,
                                 controller=jcontroller,
                                 DivergenceError=DivergenceError)


@pytest.fixture()
def world1():
    ctx = hvd.init(device="cpu")
    try:
        yield ctx
    finally:
        hvd.shutdown()


class _Probe(torch.nn.Module):
    """``loss(G) = (w * G).sum()``: the gradient of ``w`` is ``G``."""

    def __init__(self, shape=SHAPE, dtype=torch.float32):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(shape, dtype=dtype))

    def forward(self, g):
        return (self.w * g).sum()


def _grads(steps, n, bad_step, bad_rank, bad, shape=SHAPE, seed=0,
           scale=1.0):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((steps, n) + shape) * scale).astype(np.float32)
    if bad_step is not None:
        g[bad_step, bad_rank].flat[0] = bad
    return g


def _port_run(policy, g, rank=0, opt_kw=None, shape=SHAPE):
    """The port's guarded SGD over the gradient sequence ``g[:, rank]``;
    returns each step's parameters and guard snapshot."""
    m = _Probe(shape)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=LR),
                                   named_parameters=m.named_parameters(),
                                   nonfinite_policy=policy,
                                   **(opt_kw or {}))
    params, snaps, name = [], [], f"run{next(_RUNS)}"
    for s in range(g.shape[0]):
        opt.zero_grad()
        scale = hvd.current_loss_scale(opt)
        m(torch.from_numpy(g[s, rank]) * scale).backward()
        opt.step()
        params.append(m.w.detach().numpy().copy())
        snaps.append(hvd.observe_guard(opt, raise_on_abort=False,
                                       name=name))
    return params, snaps, opt


def _jax_run(J, policy, g, n):
    """The JAX optimizer under ``shard_map`` on an n-device mesh, each
    rank fed ``g[:, rank]``; returns each step's parameters and guard
    snapshot."""
    from jax.sharding import Mesh, PartitionSpec as P

    tx = J.hvd.DistributedOptimizer(J.optax.sgd(LR), axis_name="hvd",
                                    nonfinite_policy=policy)
    mesh = Mesh(np.array(J.jax.devices()[:n]), ("hvd",))

    def body(p, st, gs, scale):
        gr = J.jax.tree.map(lambda v: v[0] * scale, gs)
        upd, st = tx.update(gr, st, p)
        return J.optax.apply_updates(p, upd), st

    step = J.jax.jit(J.jax.shard_map(
        body, mesh=mesh, in_specs=(P(), P(), P("hvd"), P()),
        out_specs=(P(), P()), check_vma=False))
    p = {"w": J.jnp.ones(g.shape[2:], J.jnp.float32)}
    st = tx.init(p)
    params, snaps = [], []
    for s in range(g.shape[0]):
        scale = J.integrity.current_loss_scale(st)
        p, st = step(p, st, {"w": J.jnp.asarray(g[s])}, scale)
        params.append(np.asarray(p["w"]))
        snaps.append(J.integrity.observe_guard(st, raise_on_abort=False,
                                               name="port-parity"))
    return params, snaps


def _assert_same_run(port, jax_run, what):
    for s, (pp, ps, jp, js) in enumerate(zip(port[0], port[1], jax_run[0],
                                             jax_run[1])):
        for key in ("policy", "nonfinite_steps", "good_steps", "loss_scale",
                    "last_ok"):
            assert ps[key] == js[key], (what, s, key, ps, js)
        np.testing.assert_allclose(pp, jp, rtol=PARAM_TOL, atol=PARAM_TOL,
                                   err_msg=f"{what} step {s}")


# -- policy resolution, all_finite, sanitize ---------------------------------

def test_resolve_policy_validates(J):
    for mod in (integrity, J.integrity):
        assert mod.resolve_nonfinite_policy("skip_step") == "skip_step"
        assert mod.resolve_nonfinite_policy("off") is None
        with pytest.raises(ValueError, match="unknown non-finite policy"):
            mod.resolve_nonfinite_policy("exploded")
        with pytest.raises(ValueError, match="unknown divergence policy"):
            mod.resolve_diverge_policy("yolo")
    assert integrity.NONFINITE_POLICIES == J.integrity.NONFINITE_POLICIES
    assert integrity.DIVERGE_POLICIES == J.integrity.DIVERGE_POLICIES


def test_all_finite_and_sanitize(J):
    """Same tree through both packages: the flag and the sanitized
    values equal (an Inf becomes 0, not the largest float)."""
    raw = {"a": np.array([1.0, np.nan], np.float32),
           "b": np.array([1, 2], np.int32),
           "c": np.array([np.inf, -np.inf, 3.0], np.float32)}
    tt = {k: torch.from_numpy(v.copy()) for k, v in raw.items()}
    jt = {k: J.jnp.asarray(v) for k, v in raw.items()}
    assert bool(integrity.all_finite(tt)) == bool(
        J.integrity.all_finite(jt)) is False
    clean_t, clean_j = integrity.sanitize(tt), J.integrity.sanitize(jt)
    for k in raw:
        np.testing.assert_array_equal(clean_t[k].numpy(),
                                      np.asarray(clean_j[k]))
    assert bool(integrity.all_finite(clean_t))
    assert bool(integrity.all_finite({"ok": torch.ones(3)}))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unscale_matches_jax(J, rng, dtype):
    """``scale_backoff``'s unscale of one fused bucket (K1's plain version
    with ``1 / loss_scale`` rounded to the bucket's dtype) is JAX's
    per-leaf ``g * inv.astype(g.dtype)`` to the bit, at the initial scale
    and after backoffs to odd powers."""
    x = (rng.standard_normal(9001) * 3e4).astype(np.float32)
    xj = J.jnp.asarray(x, getattr(J.jnp, dtype))
    xt = torch.from_numpy(np.array(xj.astype(J.jnp.float32))).to(
        getattr(torch, dtype))
    for scale in (2.0 ** 15, 2.0 ** 7, 3.0 * 2 ** 10):
        guard = integrity.GuardState("scale_backoff", loss_scale=scale)
        inv = integrity.inverse_scale(guard)
        got = kernels.scale_buffer(
            xt, torch.tensor(float(inv), dtype=xt.dtype).item())
        jinv = (1.0 / J.jnp.asarray(scale, J.jnp.float32)).astype(
            J.jnp.float32)
        want = xj * jinv.astype(xj.dtype)
        np.testing.assert_array_equal(
            got.to(torch.float32).numpy(),
            np.asarray(want.astype(J.jnp.float32)))


# -- the guard on DistributedOptimizer, one process --------------------------

@pytest.mark.parametrize("policy", ["warn", "skip_step", "zero",
                                    "scale_backoff", "abort"])
@pytest.mark.parametrize("bad", ["nan", "inf"])
def test_guarded_sgd_matches_jax(J, world1, policy, bad):
    """Good, bad, good: every step's parameters (1e-6) and guard
    snapshot (exact) equal the JAX optimizer's on a one-device mesh."""
    g = _grads(3, 1, 1, 0, np.nan if bad == "nan" else np.inf)
    port = _port_run(policy, g)
    _assert_same_run(port, _jax_run(J, policy, g, 1), policy)


def test_skip_step_protects_state_and_params(world1):
    """A skipped step leaves every weight and every AdamW state tensor
    bitwise as it was, the gradient as backprop left it, and the next
    good step applies."""
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.Tanh(),
                            torch.nn.Linear(4, 3))
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(m.parameters(),
                                                     lr=1e-2),
                                   named_parameters=m.named_parameters(),
                                   nonfinite_policy="skip_step")
    x, y = torch.randn(6, 5), torch.randn(6, 3)

    def step(poison):
        opt.zero_grad()
        loss = ((m(x) - y) ** 2).mean()
        if poison:
            loss = loss * float("nan")
        loss.backward()
        opt.step()

    def state():
        return ({k: v.clone() for k, v in m.state_dict().items()},
                {i: {k: v.clone() for k, v in s.items()}
                 for i, s in enumerate(opt.state.values())})

    step(False)
    params, st = state()
    step(True)
    grads = [p.grad.clone() for p in m.parameters()]
    params2, st2 = state()
    for k in params:
        assert torch.equal(params[k], params2[k]), k
    for i in st:
        for k in st[i]:
            assert torch.equal(st[i][k], st2[i][k]), (i, k)
    assert all(torch.isnan(g).all() for g in grads)
    snap = hvd.observe_guard(opt)
    assert snap["nonfinite_steps"] == 1 and not snap["last_ok"]
    step(False)
    assert not torch.equal(m.state_dict()["0.weight"], params["0.weight"])
    assert hvd.observe_guard(opt)["last_ok"]


def test_warn_and_zero_policies(J, world1):
    """warn applies the poisoned update and counts it; zero drops the
    non-finite entries and applies the rest: both as JAX does."""
    g = _grads(2, 1, 0, 0, np.nan)
    for policy in ("warn", "zero"):
        port = _port_run(policy, g)
        _assert_same_run(port, _jax_run(J, policy, g, 1), policy)
        finite = np.isfinite(port[0][0]).all()
        assert finite == (policy == "zero")
        assert port[1][-1]["nonfinite_steps"] == 1


def test_scale_backoff_dynamics(J, world1, monkeypatch):
    """The loss-scale sequence (back off on a bad step, grow after
    ``growth_steps`` good ones, clamp at the bounds) and the unscaled
    updates equal JAX's exactly; the gradients fed are the loss scale
    times a fixed gradient, as a scaled loss gives them."""
    monkeypatch.setenv("HVD_TPU_SCALE_GROWTH_STEPS", "2")
    monkeypatch.setenv("HVD_TPU_SCALE_MAX", str(2.0 ** 16))
    g = _grads(8, 1, None, 0, np.inf)
    g[0, 0].flat[0] = np.inf
    g[5, 0].flat[3] = np.nan
    port = _port_run("scale_backoff", g)
    _assert_same_run(port, _jax_run(J, "scale_backoff", g, 1),
                     "scale_backoff")
    scales = [s["loss_scale"] for s in port[1]]
    assert scales == [2.0 ** 14, 2.0 ** 14, 2.0 ** 15, 2.0 ** 15,
                      2.0 ** 16, 2.0 ** 15, 2.0 ** 15, 2.0 ** 16]
    np.testing.assert_array_equal(port[0][0], np.ones(SHAPE, np.float32))


def test_abort_policy_raises_on_observe(world1):
    """abort skips the step (parameters untouched) and the host
    observation raises NonFiniteError."""
    g = _grads(1, 1, 0, 0, np.nan, shape=(2, 2))
    params, snaps, opt = _port_run("abort", g, shape=(2, 2))
    np.testing.assert_array_equal(params[0], np.ones((2, 2), np.float32))
    assert snaps[0]["nonfinite_steps"] == 1
    with pytest.raises(hvd.NonFiniteError, match="abort"):
        hvd.observe_guard(opt)


def test_guard_state_travels_in_state_dict(world1):
    """``state_dict()`` carries the guard beside the base state;
    ``load_state_dict`` restores counters and loss scale into a fresh
    optimizer."""
    g = _grads(3, 1, 1, 0, np.inf)
    _, snaps, opt = _port_run("scale_backoff", g)
    sd = opt.state_dict()
    assert sd["guard_state"] == snaps[-1]
    fresh = hvd.DistributedOptimizer(
        torch.optim.SGD(_Probe().parameters(), lr=LR),
        nonfinite_policy="scale_backoff")
    assert hvd.current_loss_scale(fresh) == 2.0 ** 15
    fresh.load_state_dict(sd)
    assert hvd.observe_guard(fresh) == snaps[-1]
    assert hvd.current_loss_scale(fresh) == 2.0 ** 14


def test_observe_guard_publishes_the_delta(world1):
    """``hvd_tpu_nonfinite_steps_total{policy=}`` grows by the new
    non-finite steps at each observation, once."""
    def count():
        fam = metrics_lib.metrics()["hvd_tpu_nonfinite_steps_total"]
        return sum(s["value"] for s in fam["samples"]
                   if s["labels"].get("policy") == "zero")

    before = count()
    _, _, opt = _port_run("zero", _grads(2, 1, 0, 0, np.nan))
    assert count() == before + 1
    hvd.observe_guard(opt, name="again")
    hvd.observe_guard(opt, name="again")
    assert count() == before + 2
    assert hvd.observe_guard(object()) is None


# -- divergence detection ----------------------------------------------------

def test_fingerprint_moves_on_perturbation():
    tree = {"w": torch.arange(1000, dtype=torch.float32)}
    a = integrity.fingerprint(tree)
    perturbed = {"w": torch.arange(1000, dtype=torch.float32)}
    perturbed["w"][500] += 0.1
    assert not torch.equal(a, integrity.fingerprint(perturbed))
    assert integrity.fingerprint_digest(tree) != \
        integrity.fingerprint_digest(perturbed)
    assert integrity.fingerprint_digest(tree) == integrity.fingerprint_digest(
        {"w": torch.arange(1000, dtype=torch.float32)})


@pytest.mark.parametrize("sizes", [(1000,), (7, 3), (4097, 2, 1),
                                   (1,)], ids=str)
def test_fingerprint_matches_jax(J, rng, sizes):
    """The chunk norms and samples of a dict tree equal JAX's to 1e-6
    relative (dict leaves in sorted key order in both)."""
    raw = {f"p{i}": (rng.standard_normal(s) * 5).astype(np.float32)
           for i, s in enumerate(sizes)}
    raw["a_bf16"] = rng.standard_normal(33).astype(np.float32)
    jt = {k: J.jnp.asarray(v) for k, v in raw.items()}
    jt["a_bf16"] = jt["a_bf16"].astype(J.jnp.bfloat16)
    tt = {k: torch.from_numpy(v) for k, v in raw.items()}
    tt["a_bf16"] = torch.from_numpy(np.array(
        jt["a_bf16"].astype(J.jnp.float32))).to(torch.bfloat16)
    got = integrity.fingerprint(tt).numpy()
    want = np.asarray(J.integrity.fingerprint(jt))
    np.testing.assert_allclose(got, want, rtol=FP_RTOL, atol=0)


@pytest.mark.parametrize("policy", ["warn", "abort"])
def test_divergence_detector_names_offenders(J, policy):
    """Three ranks on threads, rank 2 perturbed: every rank's port
    detector names rank 2 (abort raises naming it), as the JAX detector
    does over its own controller."""
    def run(ctl_mod, make_tree, det_cls, error_cls):
        transport = ctl_mod.InMemoryTransport()
        results = {}

        def worker(rank):
            c = ctl_mod.Controller(rank, 3, transport, timeout_s=10.0)
            det = det_cls(every_steps=1, policy=policy, controller=c)
            try:
                results[rank] = det.check(make_tree(rank == 2), step=0)
            except error_cls as e:
                results[rank] = e

        threads = [threading.Thread(target=worker, args=(r,))
                   for r in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return results

    def torch_tree(bad):
        w = torch.arange(8.0)
        if bad:
            w[0] += 1.0
        return {"w": w}

    def jax_tree(bad):
        w = J.jnp.arange(8.0)
        return {"w": w.at[0].add(1.0) if bad else w}

    port = run(port_controller, torch_tree, integrity.DivergenceDetector,
               hvd.DivergenceError)
    ref = run(J.controller, jax_tree, J.integrity.DivergenceDetector,
              J.DivergenceError)
    for r in range(3):
        if policy == "abort":
            assert isinstance(port[r], hvd.DivergenceError), port
            assert port[r].ranks == ref[r].ranks == (2,)
        else:
            assert port[r]["ranks"] == ref[r]["ranks"] == (2,), (port, ref)
            assert not port[r]["ok"] and not port[r]["needs_resync"]


def test_divergence_detector_off_cadence_and_single_process(world1):
    det = integrity.DivergenceDetector(every_steps=3, policy="resync")
    tree = {"w": torch.ones(5)}
    assert det.check(tree, step=1) is None
    rep = det.check(tree, step=3)
    assert rep["ok"] and rep["ranks"] == () and det.checks == 1
    assert integrity.divergence_guard(tree, 4, every=2) == (True, False)
    assert integrity.divergence_guard(tree, 3, every=2) == (False, False)


def test_chaos_hooks_wait_for_the_fault_plan():
    for fn in (integrity.chaos_poison, integrity.chaos_perturb):
        with pytest.raises(NotImplementedError, match="elastic"):
            fn({"w": torch.ones(2)})


# -- two gloo ranks ----------------------------------------------------------

MR_STEPS = 3


def _guard_worker(rank: int, n: int, out_path: str) -> None:
    """One rank of the n-process world (run as a script)."""
    hvd.init(device="cpu")
    assert hvd.rank() == rank and hvd.size() == n
    out = {}
    g = _grads(MR_STEPS, n, 1, 1, np.nan)
    params, snaps, opt = _port_run("skip_step", g, rank=rank)
    for s, p in enumerate(params):
        out[f"skip/{s}"] = p
        out[f"skip/{s}/nonfinite"] = np.array(snaps[s]["nonfinite_steps"])
    out["skip/agreements"] = np.array(opt.guard_agreements)
    # int8_ef + skip_step: the residual and rounding step across the skip,
    # and the same run without the bad step.
    ge = _grads(MR_STEPS, n, 1, 1, np.nan, shape=EF_SHAPE, seed=3)
    kw = {"compression": "int8_ef", "quantize_min_bucket_bytes": 0}
    m = _Probe(EF_SHAPE)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=LR),
                                   nonfinite_policy="skip_step", **kw)
    assert opt._dist_plan.wire_dtypes == ("int8",)
    for s in range(MR_STEPS):
        opt.zero_grad()
        m(torch.from_numpy(ge[s, rank])).backward()
        opt.step()
        out[f"ef/{s}/w"] = m.w.detach().numpy().copy()
        out[f"ef/{s}/res"] = opt._ef_residual[0].numpy().copy()
        out[f"ef/{s}/step"] = np.array(opt._ef_step)
    good = ge[[0, 2]]
    m2 = _Probe(EF_SHAPE)
    ref = hvd.DistributedOptimizer(torch.optim.SGD(m2.parameters(), lr=LR),
                                   **kw)
    for s in range(2):
        ref.zero_grad()
        m2(torch.from_numpy(good[s, rank])).backward()
        ref.step()
    out["ef/ref/w"] = m2.w.detach().numpy().copy()
    out["ef/ref/res"] = ref._ef_residual[0].numpy().copy()
    # Divergence: rank 1 perturbed, healed from rank 0.
    torch.manual_seed(0)
    net = torch.nn.Linear(6, 5)
    if rank == 1:
        with torch.no_grad():
            net.weight[2, 3] += 0.5
    out["div/off"] = np.array(integrity.divergence_guard(
        net, 1, every=2, policy="resync"))
    out["div/on"] = np.array(integrity.divergence_guard(
        net, 2, every=2, policy="resync"))
    out["div/after"] = np.array(integrity.check_divergence(net)[1])
    out["div/w"] = net.weight.detach().numpy().copy()
    hvd.shutdown()
    np.savez(out_path, **out)


def _run_world(n, out):
    run_ranks(__file__, lambda r: ("--guard-worker", r, n,
                                   out / f"rank{r}.npz"), n)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(n)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _run_world(2, tmp_path_factory.mktemp("guard2"))


def test_multirank_skip_step_matches_jax(J, world2):
    """A NaN on rank 1 at step 2: one agreement a step, every rank skips,
    and both ranks' parameters equal the JAX optimizer's on a two-device
    mesh (1e-6) and each other (bitwise)."""
    g = _grads(MR_STEPS, 2, 1, 1, np.nan)
    jparams, jsnaps = _jax_run(J, "skip_step", g, 2)
    for r, rank in enumerate(world2):
        assert int(rank["skip/agreements"]) == MR_STEPS
        for s in range(MR_STEPS):
            np.testing.assert_allclose(rank[f"skip/{s}"], jparams[s],
                                       rtol=PARAM_TOL, atol=PARAM_TOL,
                                       err_msg=f"rank {r} step {s}")
            np.testing.assert_array_equal(rank[f"skip/{s}"],
                                          world2[0][f"skip/{s}"])
            assert int(rank[f"skip/{s}/nonfinite"]) == \
                jsnaps[s]["nonfinite_steps"]
    np.testing.assert_array_equal(world2[0]["skip/1"], world2[0]["skip/0"])


def test_skip_step_leaves_ef_residual_untouched(world2):
    """int8_ef + skip_step: across the skipped step the residual and the
    rounding step stay bitwise as they were on every rank, and the run
    continues bitwise as the same run without the bad step."""
    for r, rank in enumerate(world2):
        assert [int(rank[f"ef/{s}/step"]) for s in range(MR_STEPS)] == \
            [1, 1, 2]
        np.testing.assert_array_equal(rank["ef/1/res"], rank["ef/0/res"])
        np.testing.assert_array_equal(rank["ef/1/w"], rank["ef/0/w"])
        assert np.abs(rank["ef/0/res"]).max() > 0, r
        np.testing.assert_array_equal(rank["ef/2/w"], rank["ef/ref/w"])
        np.testing.assert_array_equal(rank["ef/2/res"], rank["ef/ref/res"])


def test_divergence_guard_resyncs_from_rank0(world2):
    """Off cadence nothing is checked; on cadence both ranks see the
    divergence and rank 1 is healed to rank 0's weights, bitwise."""
    for rank in world2:
        assert rank["div/off"].tolist() == [False, False]
        assert rank["div/on"].tolist() == [True, True]
        assert float(rank["div/after"]) == 0.0
    np.testing.assert_array_equal(world2[1]["div/w"], world2[0]["div/w"])


if __name__ == "__main__" and sys.argv[1:2] == ["--guard-worker"]:
    _guard_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
