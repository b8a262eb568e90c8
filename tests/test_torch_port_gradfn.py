"""The port's ``DistributedGradFn`` and ``DistributedOptimizer(op=Adasum,
parallel=)`` against the JAX package's.

* ``DistributedGradFn``, in a gloo world of 2 (each rank a process
  running this file as ``--gradfn-worker RANK N OUT``): the oracles of
  the JAX tests' ``DistributedGradFn`` cases (``test_optimizer.py``,
  ``test_accum.py``, ``test_integrity.py``, ``test_overlap.py``), each
  rank's inputs the JAX rank's. The JAX side is the JAX function under
  ``shard_map`` on a 2-device CPU mesh. fp32 rtol/atol ``TOL`` = 2e-5;
  the guard's zeros and counters, and overlap on against off, exactly;
  int8_ef with the JAX test's stochastic bound (the rounding draws
  differ between the packages), and bitwise against the port's own
  ``DistributedOptimizer`` on the same gradients and bucket plan.
* Adasum with ``parallel="dp=2,tp=2"`` (a world of 4): SGD, each rank's
  own gradients; the new parameters against the JAX routed Adasum
  (each gradient pmean-combined over tp, then ``mesh_allreduce(op=
  ADASUM)`` over the dp plan, under ``shard_map`` on a ("dp", "tp")
  mesh) to 1e-5 of the largest value, and bitwise equal on all four
  ranks.

JAX is imported only inside the ``J`` fixture.
"""

import sys
import types

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from test_torch_port_worlds import run_ranks, session_world

TOL = 2e-5
ADASUM_RTOL = 1e-5
LR = 0.1


def _data():
    g = np.random.default_rng(1717)
    f = lambda *s: g.standard_normal(s).astype(np.float32)  # noqa: E731
    X_acc = f(2, 4, 5)
    X_nan = X_acc.copy()
    X_nan[:, 0, 0] = np.nan          # microbatch 0 of 2, every rank
    return {"w3": f(3), "X3": f(2, 2, 3),
            "w256": f(256), "X256": f(2, 2, 256),
            "w5": f(5), "Xa": X_acc, "Ya": f(2, 4), "Xnan": X_nan,
            "w64": f(64), "X64": f(2, 4, 64), "Y64": f(2, 4),
            "mlp": {f"l{i}": {"w": f(8, 8) * 0.5, "b": f(8) * 0.1}
                    for i in range(3)},
            "Xm": f(2, 8, 8),
            "ad_w": f(6, 4), "ad_b": f(4), "ad_g": f(4, 6, 4),
            "ad_gb": f(4, 4)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _param(a):
    return _t(a).requires_grad_()


def _grad(loss):
    """``grad_fn`` of a loss over one tensor: d loss / d w."""
    def fn(w, *batch):
        w = w.detach().requires_grad_()
        return torch.autograd.grad(loss(w, *batch), w)[0]
    return fn


def _mse(w, xb, yb):
    return ((xb @ w - yb) ** 2).mean()


def _mlp_loss(p, xb):
    h = xb
    for k in sorted(p):
        h = torch.tanh(h @ p[k]["w"] + p[k]["b"])
    return (h ** 2).mean()


def _gradfn_world(rank: int, n: int, out: dict) -> None:
    hvd.init(device="cpu")
    d = _data()
    sq = lambda w, xb: ((xb @ w) ** 2).sum()  # noqa: E731
    # (a) the plain average (test_optimizer.py::test_distributed_grad_fn).
    out["plain"] = hvd.DistributedGradFn(_grad(sq))(
        _t(d["w3"]), _t(d["X3"][rank])).numpy()
    # (b) int8_ef threads its state; against the port's optimizer.
    gfn = hvd.DistributedGradFn(_grad(sq), compression="int8_ef",
                                quantize_min_bucket_bytes=0)
    ef = gfn.init_ef_state()
    g1, ef = gfn(_t(d["w256"]), _t(d["X256"][rank]), ef_state=ef)
    g2, ef = gfn(_t(d["w256"]), _t(d["X256"][rank]), ef_state=ef)
    out["ef/g1"], out["ef/g2"] = g1.numpy(), g2.numpy()
    out["ef/step"] = np.int64(ef.step)
    w = _param(d["w256"])
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.0),
                                   compression="int8_ef",
                                   quantize_min_bucket_bytes=0)
    sq(w, _t(d["X256"][rank])).backward()
    opt.step()
    out["ef/opt_g1"] = w.grad.numpy().copy()
    # (c) accum_steps=2 against the unaccumulated reduced gradient.
    xa, ya = _t(d["Xa"][rank]), _t(d["Ya"][rank])
    out["acc/ref"] = hvd.DistributedGradFn(_grad(_mse))(
        _t(d["w5"]), xa, ya).numpy()
    wa = _param(d["w5"])
    stale = torch.full_like(wa, 7.0)
    wa.grad = stale
    val, acc = hvd.DistributedGradFn(_mse, accum_steps=2, has_value=True)(
        wa, xa, ya)
    out["acc/acc"], out["acc/value"] = acc.numpy(), val.numpy()
    out["acc/grad_kept"] = np.array(wa.grad is stale)
    # (d) accumulation under the guard: a NaN microbatch skips the step.
    g, guard = hvd.DistributedGradFn(
        _mse, accum_steps=2, nonfinite_policy="skip_step")(
        _param(d["w5"]), _t(d["Xnan"][rank]), ya)
    out["guard_acc/g"] = g.numpy()
    out["guard_acc/bad"] = np.int64(guard.nonfinite_steps)
    out["guard_acc/ok"] = np.array(bool(guard.last_ok))
    # (e) overlap under accumulation: bitwise.
    for on in (False, True):
        out[f"ov_acc/{on}"] = hvd.DistributedGradFn(
            _mse, accum_steps=2, overlap=on, fusion_threshold_bytes=64)(
            _param(d["w64"]), _t(d["X64"][rank]), _t(d["Y64"][rank])
        ).numpy()
    # (f) the guard appends its state (test_integrity.py).
    gfn = hvd.DistributedGradFn(
        lambda p, x: {"w": x.clone()}, nonfinite_policy="skip_step")
    gs = gfn.init_guard_state()
    p = {"w": torch.ones(4, 4)}
    g, gs = gfn(p, torch.ones(4, 4), guard_state=gs)
    out["guard/g1"] = g["w"].numpy()
    x = torch.ones(4, 4)
    if rank == 1:
        x[1, 1] = float("inf")
    g, gs = gfn(p, x, guard_state=gs)
    out["guard/g2"] = g["w"].numpy()
    out["guard/bad"] = np.int64(gs.nonfinite_steps)
    # (g) an MLP tree, overlap on against off (test_overlap.py).
    mlp = {k: {n_: _t(v) for n_, v in layer.items()}
           for k, layer in d["mlp"].items()}

    def mlp_grads(p, xb):
        leaves = {k: {n_: v.detach().requires_grad_() for n_, v in
                      layer.items()} for k, layer in p.items()}
        flat = [leaves[k][n_] for k in sorted(leaves) for n_ in ("b", "w")]
        gs_ = torch.autograd.grad(_mlp_loss(leaves, xb), flat)
        it = iter(gs_)
        return {k: {n_: next(it) for n_ in ("b", "w")}
                for k in sorted(leaves)}

    for on in (False, True):
        g = hvd.DistributedGradFn(mlp_grads, fusion_threshold_bytes=(
            8 * 8 + 8) * 4, overlap=on)(mlp, _t(d["Xm"][rank]))
        for k in sorted(g):
            for n_ in ("b", "w"):
                out[f"mlp/{on}/{k}/{n_}"] = g[k][n_].numpy()
    hvd.shutdown()


def _adasum_world(rank: int, out: dict) -> None:
    hvd.init(device="cpu", parallel="dp=2,tp=2")
    d = _data()
    w, b = _param(d["ad_w"]), _param(d["ad_b"])
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w, b], lr=LR),
                                   op=hvd.Adasum, parallel="dp=2,tp=2")
    w.grad, b.grad = _t(d["ad_g"][rank]), _t(d["ad_gb"][rank])
    opt.step()
    out["adasum/w"] = w.detach().numpy().copy()
    out["adasum/b"] = b.detach().numpy().copy()
    out["adasum/reductions"] = np.int64(opt.adasum_reductions)
    hvd.shutdown()


def _worker(rank: int, n: int, out_path: str) -> None:
    torch.set_num_threads(1)
    out = {}
    if n == 2:
        _gradfn_world(rank, n, out)
    else:
        _adasum_world(rank, out)
    np.savez(out_path, **out)


def _run(root, n):
    run_ranks(__file__, lambda r: ["--gradfn-worker", r, n,
                                   root / f"n{n}.rank{r}.npz"], n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    def run(root):
        _run(root, 2)
        _run(root, 4)

    root = session_world(tmp_path_factory, "torch_gradfn", run)
    return {n: [dict(np.load(root / f"n{n}.rank{r}.npz"))
                for r in range(n)] for n in (2, 4)}


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp

    import horovod_tpu as hvd_jax
    from horovod_tpu.ops import collectives as jC

    return types.SimpleNamespace(jax=jax, jnp=jnp, hvd=hvd_jax, C=jC)


def _jax_run(J, n, fn, *stacked, axes=("hvd",), shape=None):
    """``fn`` on each rank's row of ``stacked`` under shard_map on an
    n-device mesh; returns its outputs by rank."""
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(J.jax.devices()[:n]).reshape(shape or (n,)), axes)

    def body(*blocks):
        outs = fn(*[b.reshape(b.shape[len(axes):]) for b in blocks])
        outs = outs if isinstance(outs, tuple) else (outs,)
        return tuple(o.reshape((1,) * len(axes) + o.shape) for o in outs)

    f = J.jax.jit(J.jax.shard_map(body, mesh=mesh,
                                  in_specs=tuple(P(*axes) for _ in stacked),
                                  out_specs=P(*axes), check_vma=False))
    outs = f(*[J.jnp.asarray(np.asarray(s).reshape(
        (shape or (n,)) + np.asarray(s).shape[1:])) for s in stacked])
    return [np.asarray(o).reshape((n,) + o.shape[len(axes):]) for o in outs]


def test_gradfn_plain_average_matches_jax(J, ranks):
    d = _data()
    gfn = J.hvd.DistributedGradFn(J.jax.grad(
        lambda w, xb: J.jnp.sum((xb @ w) ** 2)), axis_name="hvd",
        fusion_threshold_bytes=1 << 20)
    (want,) = _jax_run(J, 2, lambda x: gfn(J.jnp.asarray(d["w3"]), x),
                       d["X3"])
    for r in range(2):
        np.testing.assert_allclose(ranks[2][r]["plain"], want[r],
                                   rtol=TOL, atol=TOL)


def test_gradfn_int8_ef_threads_its_state(ranks):
    """Two calls with the state threaded: step 2, each result within the
    JAX test's stochastic bound of the exact mean; the first call bitwise
    the port's ``DistributedOptimizer(compression="int8_ef")`` on the
    same gradients (same bucket plan, same rounding keys)."""
    d = _data()
    per_rank = [2 * d["X256"][r].T @ (d["X256"][r] @ d["w256"])
                for r in range(2)]
    expected = np.mean(per_rank, axis=0)
    bound = 2 * (sum(np.abs(p).max() for p in per_rank)
                 + np.abs(np.sum(per_rank, axis=0)).max()) / 127 / 2 + 1e-4
    for r in range(2):
        rr = ranks[2][r]
        assert rr["ef/step"] == 2
        for k in ("ef/g1", "ef/g2"):
            assert np.abs(rr[k] - expected).max() <= bound
        np.testing.assert_array_equal(rr["ef/g1"], rr["ef/opt_g1"])
        np.testing.assert_array_equal(rr["ef/g1"], ranks[2][0]["ef/g1"])
    assert not np.array_equal(ranks[2][0]["ef/g1"], ranks[2][0]["ef/g2"])


def test_gradfn_accum_matches_large_batch_and_jax(J, ranks):
    d = _data()
    acc_fn = J.hvd.DistributedGradFn(
        lambda w, xb, yb: J.jnp.mean((xb @ w - yb) ** 2), axis_name="hvd",
        accum_steps=2, has_value=True, fusion_threshold_bytes=1 << 20)
    val, want = _jax_run(J, 2, lambda x, y: acc_fn(J.jnp.asarray(d["w5"]),
                                                   x, y), d["Xa"], d["Ya"])
    for r in range(2):
        rr = ranks[2][r]
        np.testing.assert_allclose(rr["acc/acc"], rr["acc/ref"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rr["acc/acc"], want[r], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(rr["acc/value"], val[r], rtol=TOL,
                                   atol=TOL)
        assert bool(rr["acc/grad_kept"])


def test_gradfn_accum_guard_skips_a_nonfinite_microbatch(J, ranks):
    d = _data()
    gfn = J.hvd.DistributedGradFn(
        lambda w, xb, yb: J.jnp.mean((xb @ w - yb) ** 2), axis_name="hvd",
        accum_steps=2, nonfinite_policy="skip_step",
        fusion_threshold_bytes=1 << 20)

    def step(x, y):
        g, guard = gfn(J.jnp.asarray(d["w5"]), x, y)
        return g, guard.nonfinite_steps, guard.last_ok

    g, bad, ok = _jax_run(J, 2, step, d["Xnan"], d["Ya"])
    for r in range(2):
        rr = ranks[2][r]
        np.testing.assert_array_equal(rr["guard_acc/g"], g[r])
        assert rr["guard_acc/bad"] == int(bad[r]) == 1
        assert bool(rr["guard_acc/ok"]) is bool(ok[r]) is False


def test_gradfn_overlap_is_scheduling_only(ranks):
    for rr in ranks[2]:
        np.testing.assert_array_equal(rr["ov_acc/False"], rr["ov_acc/True"])
        for k in [k for k in rr if k.startswith("mlp/False/")]:
            np.testing.assert_array_equal(
                rr[k], rr[k.replace("/False/", "/True/")])


def test_gradfn_mlp_tree_matches_jax(J, ranks):
    d = _data()

    def loss(p, xb):
        h = xb
        for k in sorted(p):
            h = J.jnp.tanh(h @ p[k]["w"] + p[k]["b"])
        return J.jnp.mean(h ** 2)

    gfn = J.hvd.DistributedGradFn(J.jax.grad(loss), axis_name="hvd",
                                  fusion_threshold_bytes=(8 * 8 + 8) * 4)
    params = J.jax.tree.map(J.jnp.asarray, d["mlp"])
    outs = _jax_run(J, 2, lambda x: tuple(
        v for k in sorted(params) for v in (
            gfn(params, x)[k]["b"], gfn(params, x)[k]["w"])), d["Xm"])
    names = [(k, n_) for k in sorted(params) for n_ in ("b", "w")]
    for r in range(2):
        for (k, n_), want in zip(names, outs):
            np.testing.assert_allclose(ranks[2][r][f"mlp/False/{k}/{n_}"],
                                       want[r], rtol=TOL, atol=TOL)


def test_gradfn_guard_appends_its_state(ranks):
    for rr in ranks[2]:
        np.testing.assert_allclose(rr["guard/g1"], 1.0)
        np.testing.assert_array_equal(rr["guard/g2"], 0.0)
        assert rr["guard/bad"] == 1


def test_gradfn_refusals_and_env_default(monkeypatch):
    # The guard is explicit only: the env default changes no arity.
    monkeypatch.setenv("HVD_TPU_NONFINITE_POLICY", "skip_step")
    hvd.init(device="cpu")
    try:
        with pytest.raises(ValueError, match="int8_ef"):
            hvd.DistributedGradFn(lambda: None, compression="int8")
        with pytest.raises(ValueError, match="remat_policy"):
            hvd.DistributedGradFn(lambda w: w, remat_policy="dots")
        with pytest.raises(ValueError, match="accum_steps"):
            hvd.DistributedGradFn(lambda w: w, accum_steps=0)
        out = hvd.DistributedGradFn(lambda p: {"w": 2 * p["w"]})(
            {"w": torch.ones(3)})
        assert set(out) == {"w"} and torch.equal(out["w"], 2 * torch.ones(3))
    finally:
        hvd.shutdown()


def test_adasum_parallel_matches_the_jax_routed_adasum(J, ranks):
    """``DistributedOptimizer(op=Adasum, parallel="dp=2,tp=2")``, one SGD
    step: each gradient pmean-combined over tp, the Adasum of the deltas
    over dp through the router; against the JAX ``mesh_allreduce(op=
    ADASUM)`` of the combined gradients on the ("dp", "tp") mesh."""
    d = _data()
    plan = J.C.WirePlan.parse("dp:none")

    def step(g, gb):
        out = []
        for p, gr in ((d["ad_w"], g), (d["ad_b"], gb)):
            c = J.jax.lax.pmean(gr, "tp")
            out.append(J.jnp.asarray(p) - LR * J.C.mesh_allreduce(
                c, J.C.ReduceOp.ADASUM, plan))
        return tuple(out)

    w_want, b_want = _jax_run(J, 4, step, d["ad_g"], d["ad_gb"],
                              axes=("dp", "tp"), shape=(2, 2))
    for r in range(4):
        rr = ranks[4][r]
        for key, want in (("adasum/w", w_want[r]), ("adasum/b", b_want[r])):
            np.testing.assert_allclose(
                rr[key], want, rtol=0,
                atol=ADASUM_RTOL * np.abs(want).max(), err_msg=key)
            np.testing.assert_array_equal(rr[key], ranks[4][0][key])
        assert rr["adasum/reductions"] == 2


if __name__ == "__main__" and sys.argv[1:2] == ["--gradfn-worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
