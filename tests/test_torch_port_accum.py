"""The port's gradient accumulation with remat (``optim.py``
``accumulate_gradients``, ``resolve_remat_policy`` and
``DistributedOptimizer(accum_steps=, remat_policy=).accumulate``)
against the JAX package's (``horovod_tpu/optim.py``), after the
reference tests of ``tests/test_accum.py``.

* ``accumulate_gradients(loss, k)`` on the same seeded numpy inputs as
  the JAX function: value and gradients within 1e-5 in fp32 (different
  matmul kernels), and within 1e-5 of the port's own fused batch.
* Remat policies ``full``, ``dots`` and ``dots_no_batch`` give gradients
  bitwise equal to ``none`` on the CPU, on an MLP and on ``gpt_tiny``
  (whose attention is an autograd Function recomputed under remat).
* ``has_aux``: float aux averaged, integer aux the last microbatch's,
  as JAX does.
* The optimizer at one rank against the JAX optimizer under
  ``shard_map`` on a one-device mesh, with and without the guard and
  remat: parameters to 1e-5, the loss scale and counters exact; every
  bucket launches on the last microbatch (one collective round), one
  guard agreement and one int8_ef step advance per effective step; a NaN
  in one microbatch skips the whole effective step.
"""

import types

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import optim
from horovod_tpu_torch.models import gpt as gpt_mod

ACCUM_TOL = 1e-5        # accumulated vs fused batch / vs JAX, fp32
LR = 0.1


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp
    import optax

    import horovod_tpu as hvd_jax
    from horovod_tpu.common import integrity as jintegrity

    return types.SimpleNamespace(jax=jax, jnp=jnp, optax=optax, hvd=hvd_jax,
                                 integrity=jintegrity)


@pytest.fixture()
def world1():
    ctx = hvd.init(device="cpu")
    try:
        yield ctx
    finally:
        hvd.shutdown()


class _Lin(torch.nn.Module):
    """``mean((x @ w - y) ** 2)``, the reference tests' ``_mse``."""

    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(np.array(w)))

    def forward(self, xb, yb):
        return ((xb @ self.w - yb) ** 2).mean()


def _jax_mse(J, w, xb, yb):
    return J.jnp.mean((xb @ w - yb) ** 2)


def _data(rng, rows=16):
    return (rng.standard_normal((6, 3)).astype(np.float32),
            rng.standard_normal((rows, 6)).astype(np.float32),
            rng.standard_normal((rows, 3)).astype(np.float32))


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_accumulate_gradients_matches_large_batch(J, rng, k):
    w, x, y = _data(rng)
    m = _Lin(w)
    v = hvd.accumulate_gradients(m, k)(torch.from_numpy(x),
                                       torch.from_numpy(y))
    g = m.w.grad.clone()
    jv, jg = J.jax.jit(J.hvd.accumulate_gradients(
        lambda *a: _jax_mse(J, *a), k))(w, x, y)
    np.testing.assert_allclose(v.item(), float(jv), rtol=ACCUM_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=ACCUM_TOL,
                               atol=1e-6)
    m.w.grad = None
    fused = m(torch.from_numpy(x), torch.from_numpy(y))
    fused.backward()
    np.testing.assert_allclose(v.item(), fused.item(), rtol=ACCUM_TOL)
    np.testing.assert_allclose(g.numpy(), m.w.grad.numpy(), rtol=ACCUM_TOL,
                               atol=1e-6)


def _mlp_case():
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.Tanh(),
                              torch.nn.Linear(16, 3))
    x, y = torch.randn(8, 6), torch.randn(8, 3)
    return net, (lambda xb, yb: ((net(xb) - yb) ** 2).mean()), (x, y)


def _gpt_case():
    model = gpt_mod.gpt_tiny(num_layers=2, hidden=32, num_heads=2,
                             mlp_dim=64, vocab_size=64,
                             dtype=torch.float32)
    model.init_weights(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, 64, (4, 17),
                           generator=torch.Generator().manual_seed(1))

    def loss(t):
        return gpt_mod.next_token_loss(model(t[:, :-1]), t[:, 1:])

    return model, loss, (tokens,)


@pytest.mark.parametrize("case", ["mlp", "gpt_tiny"])
@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch"])
def test_accumulate_gradients_remat_policies_identical(case, policy):
    """Remat trades memory for recompute: the same program, so the
    gradients and the loss are bitwise those of ``"none"``."""
    model, loss, batch = {"mlp": _mlp_case, "gpt_tiny": _gpt_case}[case]()
    v0 = hvd.accumulate_gradients(loss, 2, "none")(*batch)
    g0 = [p.grad.clone() for p in model.parameters()]
    for p in model.parameters():
        p.grad = None
    v1 = hvd.accumulate_gradients(loss, 2, policy)(*batch)
    assert torch.equal(v0, v1)
    for a, p in zip(g0, model.parameters()):
        assert torch.equal(a, p.grad)


def test_accumulate_gradients_has_aux_mean(J):
    """Float aux leaves are averaged, integer leaves keep the last
    microbatch's: value, aux and gradient as JAX's."""
    def jloss(w, xb):
        per = (xb * w).sum(axis=1)
        return per.mean(), {"stat": per.mean() * 2.0,
                            "count": J.jnp.asarray(xb.shape[0] + xb[0, 0],
                                                   J.jnp.int32)}

    w = torch.nn.Parameter(torch.ones(3))

    def tloss(xb):
        per = (xb * w).sum(dim=1)
        return per.mean(), {"stat": per.mean() * 2.0,
                            "count": (xb.shape[0] + xb[0, 0]).to(
                                torch.int32)}

    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    (jv, jaux), jg = J.jax.jit(J.hvd.accumulate_gradients(
        jloss, 2, has_aux=True))(J.jnp.ones(3, J.jnp.float32), x)
    v, aux = hvd.accumulate_gradients(tloss, 2, has_aux=True)(
        torch.from_numpy(x))
    np.testing.assert_allclose(v.item(), float(jv), rtol=1e-6)
    np.testing.assert_allclose(aux["stat"].item(), float(jaux["stat"]),
                               rtol=1e-6)
    assert int(aux["count"]) == int(jaux["count"]) == 8
    assert aux["count"].dtype == torch.int32
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jg), rtol=1e-6)


def test_accumulate_gradients_errors(J):
    m = _Lin(np.ones((6, 3), np.float32))
    with pytest.raises(ValueError, match="does not divide"):
        hvd.accumulate_gradients(m, 3)(torch.ones(8, 6), torch.ones(8, 3))
    for mod in (optim, J.hvd.optim):
        with pytest.raises(ValueError, match="unknown remat policy"):
            mod.resolve_remat_policy("bogus")
        with pytest.raises(ValueError, match="accum_steps"):
            mod._resolve_accum_steps(0)
    assert optim.resolve_remat_policy(None)[0] == "none"
    assert optim.resolve_remat_policy("dots")[2] == (
        torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
        torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def test_accumulated_mean_is_an_fp32_sum_divided(rng):
    """A bf16 parameter's microbatch gradients are summed in fp32, divided
    by k and cast once (not summed in bf16), and the mean is added to a
    gradient already in ``p.grad``."""
    w = torch.nn.Parameter(torch.ones(5, dtype=torch.bfloat16))
    x = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32)
                         * 100).to(torch.bfloat16)
    w.grad = torch.full((5,), 0.5, dtype=torch.bfloat16)

    def loss(xb):
        return (xb * w).sum()

    hvd.accumulate_gradients(loss, 3)(x)
    parts = [x[2 * i:2 * i + 2].float().sum(0).to(torch.bfloat16).float()
             for i in range(3)]
    mean = ((parts[0] + parts[1]) + parts[2]) / 3
    assert torch.equal(w.grad, torch.full((5,), 0.5, dtype=torch.bfloat16)
                       + mean.to(torch.bfloat16))


# -- the optimizer surface ---------------------------------------------------

def _steps_data(rng, steps=3, rows=8):
    w = rng.standard_normal((6, 3)).astype(np.float32)
    x = rng.standard_normal((steps, rows, 6)).astype(np.float32)
    y = rng.standard_normal((steps, rows, 3)).astype(np.float32)
    return w, x, y


def _jax_accum_run(J, w, x, y, k, remat, policy):
    from jax.sharding import Mesh, PartitionSpec as P

    tx = J.hvd.DistributedOptimizer(J.optax.sgd(LR), axis_name="hvd",
                                    accum_steps=k, remat_policy=remat,
                                    nonfinite_policy=policy)
    mesh = Mesh(np.array(J.jax.devices()[:1]), ("hvd",))

    def body(p, st, xb, yb, scale):
        _, g = tx.accumulate(
            lambda q, a, b: _jax_mse(J, q, a, b) * scale)(p, xb, yb)
        upd, st = tx.update(g, st, p)
        return J.optax.apply_updates(p, upd), st

    step = J.jax.jit(J.jax.shard_map(
        body, mesh=mesh, in_specs=(P(),) * 5, out_specs=(P(), P()),
        check_vma=False))
    p, st = J.jnp.asarray(w), None
    st = tx.init(p)
    out = []
    for s in range(x.shape[0]):
        p, st = step(p, st, x[s], y[s],
                     J.integrity.current_loss_scale(st))
        snap = J.integrity.observe_guard(st, raise_on_abort=False,
                                         name="port-accum")
        out.append((np.asarray(p), snap))
    return out


@pytest.mark.parametrize("policy", [None, "skip_step", "scale_backoff"])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_optimizer_accumulate_end_to_end(J, world1, rng, policy, remat):
    """``DistributedOptimizer(accum_steps=4)``: three effective steps,
    the second with a NaN in its third microbatch, against the JAX
    optimizer's ``accumulate`` + ``update``. Every bucket launches on the
    last microbatch, one round and one guard agreement a step."""
    k = 4
    w, x, y = _steps_data(rng)
    x[1, 5, 2] = np.nan
    m = _Lin(w)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=LR),
                                   accum_steps=k, remat_policy=remat,
                                   nonfinite_policy=policy)
    assert opt.accum_steps == k and opt.remat_policy == remat
    launched_at = []
    launch = opt._launch

    def spy(bi):
        launched_at.append(opt._accum.index if opt._accum else None)
        return launch(bi)

    opt._launch = spy
    want = _jax_accum_run(J, w, x, y, k, remat, policy)
    fn = opt.accumulate(
        lambda xb, yb: m(xb, yb) * hvd.current_loss_scale(opt))
    for s in range(x.shape[0]):
        opt.zero_grad()
        fn(torch.from_numpy(x[s]), torch.from_numpy(y[s]))
        opt.step()
        jp, jsnap = want[s]
        np.testing.assert_allclose(m.w.detach().numpy(), jp, rtol=ACCUM_TOL,
                                   atol=ACCUM_TOL, err_msg=f"step {s}")
        if policy is not None:
            snap = hvd.observe_guard(opt, name="accum")
            for key in ("nonfinite_steps", "good_steps", "loss_scale",
                        "last_ok"):
                assert snap[key] == jsnap[key], (s, key, snap, jsnap)
    nb = len(opt._dist_plan.buckets)
    assert launched_at == [k - 1] * nb * x.shape[0]
    assert opt.bucket_allreduces == nb * x.shape[0]
    assert opt.guard_agreements == (x.shape[0] if policy else 0)
    if policy is not None:
        assert hvd.observe_guard(opt)["nonfinite_steps"] == 1


def test_optimizer_accumulate_int8_ef_advances_once(world1, rng):
    """int8_ef under accumulation: the rounding step advances once per
    effective step."""
    w, x, y = _steps_data(rng)
    m = _Lin(w)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=LR),
                                   compression="int8_ef",
                                   quantize_min_bucket_bytes=0,
                                   accum_steps=2)
    for s in range(3):
        opt.zero_grad()
        opt.accumulate(m)(torch.from_numpy(x[s]), torch.from_numpy(y[s]))
        opt.step()
    assert opt._ef_step == 3 and opt.bucket_allreduces == 3


def test_accum_conflicts_and_validation(world1):
    m = _Lin(np.ones((6, 3), np.float32))

    def make(**kw):
        return hvd.DistributedOptimizer(
            torch.optim.SGD(m.parameters(), lr=LR), **kw)

    with pytest.raises(ValueError, match="two spellings"):
        make(accum_steps=2, backward_passes_per_step=2)
    with pytest.raises(ValueError, match="unknown remat policy"):
        make(accum_steps=2, remat_policy="bogus")
    with pytest.raises(NotImplementedError, match="Queue 1"):
        make(accum_steps=2, op=hvd.Adasum)
    opt = make(backward_passes_per_step=2)
    assert opt.accum_steps == 1 and callable(opt.accumulate)
    with pytest.raises(ValueError, match="does not divide"):
        make(accum_steps=3).accumulate(m)(torch.ones(8, 6),
                                          torch.ones(8, 3))
