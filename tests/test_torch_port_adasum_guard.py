"""The port's Adasum optimizer under the non-finite guard and with
accumulation (``DistributedOptimizer(op=Adasum, nonfinite_policy=,
accum_steps=)``, ``horovod_tpu_torch/optim.py``) against the JAX
package's ``DistributedOptimizer(optax.sgd, op=ADASUM, ...)``
(``horovod_tpu/optim.py``), whose whole Adasum core runs under its
agreed ``lax.cond``.

The port's mixin reduces the optimizer's DELTAS by Adasum, the JAX
optimizer the GRADIENTS; Adasum is scale-equivariant, so under plain SGD
the port's delta is ``-lr`` times the Adasum of the gradients: the two
agree to the tolerance of ``test_torch_port_reduce.py``'s Adasum tests
(1e-5 of the largest value).

Two gloo ranks (this file run as ``--adasum-worker RANK N OUT``), the
JAX side under ``shard_map`` on a two-device CPU mesh, rank r on device
r, both fed the same seeded per-rank gradients through a ``(w *
G).sum()`` probe or the same per-rank regression batches:

* ``skip_step`` and ``scale_backoff`` with +Inf on rank 1 at step 2:
  the guard's counters and loss scale exact, parameters to 1e-5 of the
  largest value, and the skipped step bitwise a no-op (the loss scale
  halving under ``scale_backoff``); with AdamW (no JAX counterpart: its
  delta is not a gradient's) every weight, every AdamW tensor and
  ``p.grad`` bitwise unchanged across the skip;
* ``accum_steps=2`` through ``optimizer.accumulate``: one Adasum a
  parameter per effective step, parameters to 1e-5.

JAX is imported only inside the ``J`` fixture.
"""

import sys
import types

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from test_torch_port_worlds import run_ranks

ADASUM_TOL = 1e-5       # of the largest |value|, as test_torch_port_reduce
LR = 0.1
SHAPE = (5, 4)
STEPS = 4
BAD = (1, 1)            # (step index, rank) of the +Inf
POLICIES = ("skip_step", "scale_backoff")
ACCUM = 2


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp
    import optax

    import horovod_tpu as hvd_jax
    from horovod_tpu.common import integrity as jintegrity

    return types.SimpleNamespace(jax=jax, jnp=jnp, optax=optax, hvd=hvd_jax,
                                 integrity=jintegrity)


def _grads(n):
    g = np.random.default_rng(11).standard_normal(
        (STEPS, n) + SHAPE).astype(np.float32)
    g[BAD[0], BAD[1]].flat[0] = np.inf
    return g


def _batches(n):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((STEPS, n, 8, 6)).astype(np.float32)
    y = rng.standard_normal((STEPS, n, 8, 3)).astype(np.float32)
    w = rng.standard_normal((6, 3)).astype(np.float32)
    return w, x, y


class _Probe(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(SHAPE))

    def forward(self, g):
        return (self.w * g).sum()


def _guarded_run(policy, g, rank):
    m = _Probe()
    opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=LR),
                                   named_parameters=m.named_parameters(),
                                   op=hvd.Adasum, nonfinite_policy=policy)
    out = {}
    for s in range(STEPS):
        opt.zero_grad()
        scale = hvd.current_loss_scale(opt)
        m(torch.from_numpy(g[s, rank]) * scale).backward()
        opt.step()
        snap = hvd.observe_guard(opt, raise_on_abort=False,
                                 name=f"adasum-{policy}")
        out[f"{policy}/{s}/w"] = m.w.detach().numpy().copy()
        out[f"{policy}/{s}/scale"] = np.array(float(snap["loss_scale"]))
        out[f"{policy}/{s}/nonfinite"] = np.array(snap["nonfinite_steps"])
    out[f"{policy}/agreements"] = np.array(opt.guard_agreements)
    out[f"{policy}/reductions"] = np.array(opt.adasum_reductions)
    return out


def _adamw_skip(g, rank):
    """AdamW + scale_backoff: the skipped step leaves weights, AdamW state
    and p.grad bitwise as they were."""
    m = _Probe()
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(m.parameters(),
                                                     lr=1e-2),
                                   op=hvd.Adasum,
                                   nonfinite_policy="scale_backoff")
    out = {}
    for s in range(BAD[0] + 1):
        opt.zero_grad()
        scale = hvd.current_loss_scale(opt)
        m(torch.from_numpy(g[s, rank]) * scale).backward()
        if s == BAD[0]:
            w0 = m.w.detach().clone()
            st0 = {k: v.clone() for k, v in opt.state[m.w].items()}
            g0 = m.w.grad.clone()
        opt.step()
    out["adamw/w_same"] = np.array(torch.equal(m.w.detach(), w0))
    out["adamw/state_same"] = np.array(all(
        torch.equal(opt.state[m.w][k], v) for k, v in st0.items()))
    out["adamw/grad_same"] = np.array(torch.equal(m.w.grad, g0))
    out["adamw/scale"] = np.array(float(hvd.current_loss_scale(opt)))
    return out


def _mse(w, x, y):
    return ((x @ w - y) ** 2).mean()


def _accum_run(rank, n):
    w0, x, y = _batches(n)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=LR),
                                   op=hvd.Adasum, accum_steps=ACCUM)
    fn = opt.accumulate(lambda a, b: _mse(w, a, b))
    out = {}
    for s in range(STEPS):
        opt.zero_grad()
        fn(torch.from_numpy(x[s, rank]), torch.from_numpy(y[s, rank]))
        opt.step()
        out[f"accum/{s}/w"] = w.detach().numpy().copy()
    out["accum/reductions"] = np.array(opt.adasum_reductions)
    return out


def _adasum_worker(rank: int, n: int, out_path: str) -> None:
    hvd.init(device="cpu")
    assert hvd.rank() == rank and hvd.size() == n
    g = _grads(n)
    out = {}
    for policy in POLICIES:
        out.update(_guarded_run(policy, g, rank))
    out.update(_adamw_skip(g, rank))
    out.update(_accum_run(rank, n))
    hvd.shutdown()
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    out = tmp_path_factory.mktemp("adasum2")
    run_ranks(__file__, lambda r: ("--adasum-worker", r, 2,
                                   out / f"rank{r}.npz"), 2)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


def _mesh(J, n):
    from jax.sharding import Mesh

    return Mesh(np.array(J.jax.devices()[:n]), ("hvd",))


def _jax_guarded(J, policy, g):
    from jax.sharding import PartitionSpec as P

    tx = J.hvd.DistributedOptimizer(J.optax.sgd(LR), axis_name="hvd",
                                    op=J.hvd.Adasum,
                                    nonfinite_policy=policy)

    def body(p, st, gs, scale):
        upd, st = tx.update({"w": gs[0] * scale}, st, p)
        return J.optax.apply_updates(p, upd), st

    step = J.jax.jit(J.jax.shard_map(
        body, mesh=_mesh(J, g.shape[1]), in_specs=(P(), P(), P("hvd"), P()),
        out_specs=(P(), P()), check_vma=False))
    p = {"w": J.jnp.ones(SHAPE, J.jnp.float32)}
    st = tx.init(p)
    out = []
    for s in range(STEPS):
        scale = J.integrity.current_loss_scale(st)
        p, st = step(p, st, J.jnp.asarray(g[s]), scale)
        snap = J.integrity.observe_guard(st, raise_on_abort=False,
                                         name=f"port-adasum-{policy}")
        out.append((np.asarray(p["w"]), snap))
    return out


def _jax_accum(J, n):
    from jax.sharding import PartitionSpec as P

    w0, x, y = _batches(n)
    tx = J.hvd.DistributedOptimizer(J.optax.sgd(LR), axis_name="hvd",
                                    op=J.hvd.Adasum, accum_steps=ACCUM)

    def body(p, st, xb, yb):
        _, gr = tx.accumulate(lambda q, a, b: ((a @ q - b) ** 2).mean())(
            p, xb[0], yb[0])
        upd, st = tx.update(gr, st, p)
        return J.optax.apply_updates(p, upd), st

    step = J.jax.jit(J.jax.shard_map(
        body, mesh=_mesh(J, n), in_specs=(P(), P(), P("hvd"), P("hvd")),
        out_specs=(P(), P()), check_vma=False))
    p = J.jnp.asarray(w0)
    st = tx.init(p)
    out = []
    for s in range(STEPS):
        p, st = step(p, st, J.jnp.asarray(x[s]), J.jnp.asarray(y[s]))
        out.append(np.asarray(p))
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_adasum_guard_matches_jax(J, world2, policy):
    """+Inf on rank 1 at step 2: one agreement a step on both ranks, the
    skipped step changes no weight, the counters and loss scale equal
    JAX's, the weights JAX's to 1e-5 of their largest value and each
    other's bitwise."""
    ref = _jax_guarded(J, policy, _grads(2))
    for r, rank in enumerate(world2):
        assert int(rank[f"{policy}/agreements"]) == STEPS
        # One Adasum a parameter on every good step.
        assert int(rank[f"{policy}/reductions"]) == STEPS - 1
        np.testing.assert_array_equal(rank[f"{policy}/{BAD[0]}/w"],
                                      rank[f"{policy}/{BAD[0] - 1}/w"])
        for s, (jw, js) in enumerate(ref):
            w = rank[f"{policy}/{s}/w"]
            np.testing.assert_allclose(
                w, jw, rtol=0, atol=ADASUM_TOL * np.abs(jw).max(),
                err_msg=f"rank {r} step {s}")
            np.testing.assert_array_equal(w, world2[0][f"{policy}/{s}/w"])
            assert int(rank[f"{policy}/{s}/nonfinite"]) == \
                js["nonfinite_steps"]
            assert float(rank[f"{policy}/{s}/scale"]) == \
                float(js["loss_scale"])
    if policy == "scale_backoff":
        scales = [float(world2[0][f"{policy}/{s}/scale"])
                  for s in range(STEPS)]
        assert scales[BAD[0] - 1] == 2.0 ** 15
        assert scales[BAD[0]] == 2.0 ** 14


def test_adasum_skip_leaves_adamw_state_and_grads(world2):
    for rank in world2:
        assert bool(rank["adamw/w_same"])
        assert bool(rank["adamw/state_same"])
        assert bool(rank["adamw/grad_same"])
        assert float(rank["adamw/scale"]) == 2.0 ** 14


def test_adasum_accumulation_matches_jax(J, world2):
    """``accum_steps=2``: the mean gradient of the two microbatches, one
    delta step and one Adasum a parameter per effective step."""
    ref = _jax_accum(J, 2)
    for r, rank in enumerate(world2):
        assert int(rank["accum/reductions"]) == STEPS
        for s, jw in enumerate(ref):
            np.testing.assert_allclose(
                rank[f"accum/{s}/w"], jw, rtol=0,
                atol=ADASUM_TOL * np.abs(jw).max(),
                err_msg=f"rank {r} step {s}")
            np.testing.assert_array_equal(rank[f"accum/{s}/w"],
                                          world2[0][f"accum/{s}/w"])


def test_adasum_guard_and_accum_construct_in_one_process():
    """A world of one: the guard and accumulation options are taken (they
    raised before this slice) and a finite step runs."""
    hvd.init(device="cpu")
    try:
        m = _Probe()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(m.parameters(), lr=LR), op=hvd.Adasum,
            nonfinite_policy="skip_step", accum_steps=2)
        assert opt.accum_steps == 2 and opt._guard is not None
        fn = opt.accumulate(lambda g: m(g))
        fn(torch.ones((2,) + SHAPE))
        opt.step()
        assert opt.guard_agreements == 1 and opt.adasum_reductions == 1
        np.testing.assert_allclose(m.w.detach().numpy(), 1 - LR, rtol=1e-6)
        with pytest.raises(NotImplementedError, match="Adasum"):
            hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(),
                                                     lr=LR),
                                     op=hvd.Adasum,
                                     backward_passes_per_step=2)
    finally:
        hvd.shutdown()


if __name__ == "__main__" and sys.argv[1:2] == ["--adasum-worker"]:
    _adasum_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
