"""The port's ZeRO stages 1–3 and FSDP (``horovod_tpu_torch/zero.py``)
against the JAX package's (``horovod_tpu/optim.py``).

* Two gloo worlds, each run once per session through
  ``test_torch_port_worlds.run_ranks``: a flat world of 2
  (``--zero-worker RANK 2 OUT``) and a 2x2 mesh (``mesh_shape="2x2"``,
  rank ``cross * 2 + local``). The 2x2 world runs first and writes a
  sharded checkpoint that the world of 2 restores (the resize drill).
* The oracle is the JAX surface under ``shard_map`` on the conftest's
  virtual CPU devices, each device one rank's rows of the same seeded
  regression: ``sharded_update``, ``FSDPOptimizer`` and
  ``ZeroOptimizer`` stages 1, 2 (``accum_steps=2``) and 3, with
  ``optax.sgd(lr, momentum=0.9)`` against ``torch.optim.SGD(momentum=
  0.9)`` to 1e-6 relative and ``optax.adam`` against ``torch.optim.Adam``
  to 1e-5 (of the largest value).
* Stage 1 at n = 2 with ``none`` wires is held bitwise against the
  port's replicated ``DistributedOptimizer`` with the same inner
  optimizer and ``foreach`` setting.
* Stage 2 with ``accum_steps=2`` under ``skip_step`` and ``zero``, a
  NaN in one rank's second microbatch at one step: the guard sees the
  reduced shard means, on both sides.
* ``int8_ef`` (the port's stochastic draws differ from ``jax.random``'s)
  is held by the bound of one step and by the residual-sum invariant:
  with SGD at lr 1 on a linear loss, ``p_t + t * mean(G)`` equals the
  residuals summed over the ranks divided by n, to fp32 roundoff.

JAX is imported only inside the ``J`` fixture: the worker processes
import this file and must not pay for it.
"""

import sys
import types
import warnings

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint as ckpt
from horovod_tpu_torch import zero
from horovod_tpu_torch.common import integrity
from test_torch_port_worlds import run_ranks

T = 32                  # fusion threshold (bytes): b and w in two buckets
LR = {"sgd": 0.1, "adam": 1e-2}
STEPS = 3
SGD_RTOL, ADAM_TOL = 1e-6, 1e-5
CASES = ("sharded/sgd", "sharded/adam", "fsdp/sgd", "z1/sgd", "z2/sgd",
         "z3/sgd", "z1/adam", "z2/adam", "z3/adam")
GUARDED = ("z2/sgd/skip_step", "z2/sgd/zero")
ROUTED = ("sharded/sgd", "z3/sgd", "fsdp/sgd")
PLAN = "local:none,cross:none"
PLAN_Q = "local:none,cross:int8"
PROBE = (3000, 5000)    # the int8_ef probe's two parameters
CKPT_STEP = 7
REF_STEPS = 6           # the reference routed int8_ef problem
POISON = (50, 1)        # (row of y made NaN, the step that reads it)


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp
    import optax

    from horovod_tpu import optim as joptim

    return types.SimpleNamespace(jax=jax, jnp=jnp, optax=optax,
                                 optim=joptim)


def _problem():
    g = np.random.default_rng(7)
    x = g.standard_normal((64, 8)).astype(np.float32)
    w = g.standard_normal((8, 2)).astype(np.float32)
    return x, (x @ w).astype(np.float32)


def _poisoned_y():
    """``_problem``'s targets with one NaN: row 50 (rank 1 of 2, its
    second microbatch at ``accum_steps=2``), column 0, so the gradients
    of ``b[0]`` and ``w[:, 0]`` are NaN and the rest finite."""
    y = _problem()[1].copy()
    y[POISON[0], 0] = np.nan
    return y


def _probe_grads(n):
    g = np.random.default_rng(11 + n)
    return [(g.standard_normal((n,) + (k,)) * s).astype(np.float32)
            for k, s in zip(PROBE, (1.0, 3.0))]


def _ref_problem():
    """The JAX reference's routed int8_ef problem
    (``test_mesh_routing.py`` ``sharded_problem``, seed 42)."""
    g = np.random.default_rng(42)
    x = g.standard_normal((8, 16, 64)).astype(np.float32)
    w = g.standard_normal((64, 4)).astype(np.float32)
    return x, np.einsum("rbi,ij->rbj", x, w).astype(np.float32)


# -- the rank worker ----------------------------------------------------------

def _inner(name, params, **kw):
    if name == "sgd":
        return torch.optim.SGD(params, lr=LR["sgd"], momentum=0.9,
                               foreach=False, **kw)
    return torch.optim.Adam(params, lr=LR["adam"], foreach=False, **kw)


def _loss(b, w, x, y):
    return ((x @ w + b - y) ** 2).mean()


def _port_case(case, rank, n, route=None):
    """One JAX-parity case on this rank's rows: the final (b, w) and,
    for a guarded case (``kind/opt/policy``), the steps the guard found
    non-finite. A guarded case reads ``_poisoned_y`` at ``POISON``'s
    step."""
    kind, opt_name, *policy = case.split("/")
    rows = slice(rank * 64 // n, (rank + 1) * 64 // n)
    x, y = (torch.from_numpy(v[rows]) for v in _problem())
    y_bad = torch.from_numpy(_poisoned_y()[rows])
    b = torch.zeros(2, requires_grad=True)
    w = torch.zeros(8, 2, requires_grad=True)
    inner = _inner(opt_name, [b, w])

    def backward():
        b.grad = w.grad = None
        _loss(b, w, x, y).backward()

    if kind == "sharded":
        st = hvd.sharded_init(inner, [b, w], fusion_threshold_bytes=T,
                              route=route)
        for _ in range(STEPS):
            backward()
            hvd.sharded_update(st, [b.grad, w.grad], [b, w])
    elif kind == "fsdp":
        opt = hvd.FSDPOptimizer(inner, fusion_threshold_bytes=T, route=route)
        for _ in range(STEPS):
            opt.gather_params()
            backward()
            opt.step()
        opt.gather_params()
    else:
        stage = int(kind[1])
        opt = hvd.ZeroOptimizer(inner, zero_stage=stage,
                                fusion_threshold_bytes=T, route=route,
                                accum_steps=2 if stage == 2 else 1,
                                nonfinite_policy=policy[0] if policy
                                else None)
        fn = opt.accumulate(lambda xx, yy: _loss(b, w, xx, yy))
        for t in range(STEPS):
            if stage == 1:
                backward()
            else:
                fn(x, y_bad if policy and t == POISON[1] else y)
            opt.step()
        if stage == 3:
            opt.gather_params()
        if policy:
            return (b.detach().numpy().copy(), w.detach().numpy().copy(),
                    int(opt._guard.snapshot()["nonfinite_steps"]))
    return b.detach().numpy().copy(), w.detach().numpy().copy(), -1


def _probe_opt(rank, n, steps, opt_name="sgd1", nan_at=None, **kw):
    """The int8_ef / guard probe: parameters a (3000) and b (5000) with
    given gradients (``loss = (a * Ga).sum() + (b * Gb).sum()``), SGD at
    lr 1 (or Adam); returns the optimizer and each step's (a, b)."""
    ga, gb = (torch.from_numpy(g[rank]) for g in _probe_grads(n))
    a = torch.zeros(PROBE[0], requires_grad=True)
    b = torch.zeros(PROBE[1], requires_grad=True)
    inner = torch.optim.SGD([a, b], lr=1.0, foreach=False) \
        if opt_name == "sgd1" else _inner("adam", [a, b])
    opt = hvd.ZeroOptimizer(inner, **{"zero_stage": 1,
                                      "fusion_threshold_bytes": 4 * 4096,
                                      **kw})
    seen = []
    for t in range(steps):
        if opt.zero_stage == 3:
            opt.gather_params()
        a.grad = b.grad = None
        ((a * ga).sum() + (b * gb).sum()).backward()
        if t == nan_at and rank == 1:
            a.grad[0] = float("nan")
        opt.step()
        if opt.zero_stage == 3:
            opt.gather_params()
        seen.append((a.detach().clone(), b.detach().clone()))
        if opt.zero_stage == 3:
            opt.shard_params()
    return opt, (a, b), seen


def _flat_state(prefix, full, out):
    """A gathered state's tensors into ``out`` under ``prefix``."""
    for i, entry in full["state"].items():
        for k, v in entry.items():
            if torch.is_tensor(v):
                out[f"{prefix}/state/{i}/{k}"] = v.numpy().copy()
    for i, r in enumerate(full.get("ef_state", {}).get("residual", [])):
        out[f"{prefix}/residual/{i}"] = r.numpy().copy()


def _ef_run(out, tag, rank, n, route=None):
    """int8_ef, SGD lr 1, three steps: p after steps 1 and 3, the
    residuals, the replicas."""
    opt, _, seen = _probe_opt(rank, n, STEPS, compression="int8_ef",
                              route=route)
    st = opt.shard_state
    out[f"{tag}/p1"] = torch.cat(seen[0]).numpy()
    out[f"{tag}/p3"] = torch.cat(seen[-1]).numpy()
    for i, (r, bk) in enumerate(zip(st.ef_state.residual, st.plan.buckets)):
        out[f"{tag}/res/{i}"] = r[:bk.total_elems].numpy().copy()
    out[f"{tag}/buckets"] = np.array(
        [bk.leaf_indices[0] for bk in st.plan.buckets] +
        [bk.total_elems for bk in st.plan.buckets])
    out[f"{tag}/ef_step"] = np.int64(st.ef_state.step)


def _ckpt_opt(rank, n):
    """The resize drill's optimizer: stage 3, Adam, int8_ef, 2 steps of
    the probe."""
    opt, params, _ = _probe_opt(rank, n, 2, opt_name="adam",
                                zero_stage=3, compression="int8_ef")
    return opt, params


def _worker_2(rank, out, ckpt_dir):
    n = 2
    for case in CASES + GUARDED:
        (out[f"jax/{case}/b"], out[f"jax/{case}/w"],
         out[f"jax/{case}/nonfinite"]) = _port_case(case, rank, n)
    # Stage 1 against the replicated optimizer, bitwise.
    x, y = (torch.from_numpy(v[rank * 32:(rank + 1) * 32])
            for v in _problem())
    for name in ("sgd", "adam"):
        for how in ("zero", "rep"):
            b = torch.zeros(2, requires_grad=True)
            w = torch.zeros(8, 2, requires_grad=True)
            inner = _inner(name, [b, w])
            opt = hvd.ZeroOptimizer(inner, zero_stage=1,
                                    fusion_threshold_bytes=T) \
                if how == "zero" else hvd.DistributedOptimizer(
                    inner, fusion_threshold_bytes=T)
            for _ in range(STEPS):
                opt.zero_grad()
                _loss(b, w, x, y).backward()
                opt.step()
            out[f"bitwise/{name}/{how}"] = torch.cat(
                [b.detach().reshape(-1), w.detach().reshape(-1)]).numpy()
            for h in getattr(opt, "_dist_hooks", ()):
                h.remove()
    _ef_run(out, "ef", rank, n)
    # The guard: a NaN on rank 1 at step 1 (of 0, 1, 2) against the run
    # without that step; the state across the skip.
    opt, _, seen = _probe_opt(rank, n, STEPS, opt_name="adam", zero_stage=3,
                              nonfinite_policy="skip_step", nan_at=1)
    out["guard/skip_p"] = torch.cat(seen[-1]).numpy()
    out["guard/across_skip"] = np.array([
        bool(torch.equal(u, v)) for u, v in zip(seen[0], seen[1])])
    out["guard/snapshot"] = np.array([
        opt.shard_state._guard.snapshot()["nonfinite_steps"],
        opt.shard_state.guard_agreements])
    _flat_state("guard/skip", opt.gather_state(), out)
    opt, _, seen = _probe_opt(rank, n, STEPS - 1, opt_name="adam",
                              zero_stage=3, nonfinite_policy="skip_step")
    out["guard/clean_p"] = torch.cat(seen[-1]).numpy()
    _flat_state("guard/clean", opt.gather_state(), out)
    # gather_state -> reshard_state -> gather_state (int8_ef, Adam).
    opt, _, _ = _probe_opt(rank, n, 2, opt_name="adam",
                           compression="int8_ef")
    full = opt.gather_state()
    fresh, _, _ = _probe_opt(rank, n, 0, opt_name="adam",
                             compression="int8_ef")
    fresh.reshard_state(full)
    _flat_state("trip/a", full, out)
    _flat_state("trip/b", fresh.gather_state(), out)
    out["trip/res_local"] = np.array([
        float(r.double().sum()) for o in (opt, fresh)
        for r in o.shard_state.ef_state.residual])
    # The sharded fingerprint: the same on every rank, and it moves when
    # one rank's shard does.
    fp = integrity.sharded_fingerprint(opt.shard_state.shards)
    if rank == 1:
        with torch.no_grad():
            opt.shard_state.shards[0][0] += 1.0
    out["fp"] = torch.stack(
        [fp, integrity.sharded_fingerprint(opt.shard_state.shards)]).numpy()
    # The resize drill: restore the 2x2 world's checkpoint here.
    opt, params = _ckpt_opt(rank, n)
    tree, step = ckpt.restore_sharded(opt.sharded_tree(), ckpt_dir)
    opt.load_sharded_tree(tree)
    out["ckpt/step"] = np.int64(step)
    _flat_state("ckpt", opt.gather_state(), out)
    opt.gather_params()
    out["ckpt/params"] = torch.cat([p.detach() for p in params]).numpy()


def _worker_2x2(rank, out, ckpt_dir):
    n = 4
    for case in ROUTED:
        out[f"jax/{case}/b"], out[f"jax/{case}/w"], _ = _port_case(
            case, rank, n, route=PLAN)
    _ef_run(out, "ef_route", rank, n, route=PLAN_Q)
    # The JAX reference's routed int8_ef problem, two of its eight
    # ranks' batches a rank, on the int8 cross hop and on native wires.
    x, y = (torch.from_numpy(v[2 * rank:2 * rank + 2].reshape(32, -1))
            for v in _ref_problem())
    for comp in ("int8_ef", "none"):
        w = torch.zeros(64, 4, requires_grad=True)
        b = torch.zeros(4, requires_grad=True)
        opt = hvd.ZeroOptimizer(
            torch.optim.AdamW([b, w], lr=1e-2, weight_decay=1e-4,
                              foreach=False),
            zero_stage=1, route=PLAN_Q if comp == "int8_ef" else PLAN,
            compression=comp)
        for _ in range(REF_STEPS):
            opt.zero_grad()
            _loss(b, w, x, y).backward()
            opt.step()
        out[f"refprob/{comp}/w"] = w.detach().numpy().copy()
        out[f"refprob/{comp}/b"] = b.detach().numpy().copy()
    # The resize drill: save here, restored by the world of 2.
    opt, params = _ckpt_opt(rank, n)
    hvd.save_sharded(opt.sharded_tree(), ckpt_dir, CKPT_STEP)
    _flat_state("ckpt", opt.gather_state(), out)
    opt.gather_params()
    out["ckpt/params"] = torch.cat([p.detach() for p in params]).numpy()


def _zero_worker(rank: int, n: int, out_path: str, ckpt_dir: str) -> None:
    """One rank of an n-process gloo world (run as a script)."""
    torch.set_num_threads(1)
    hvd.init(device="cpu", mesh_shape="2x2" if n == 4 else None)
    assert hvd.rank() == rank and hvd.size() == n
    out = {}
    (_worker_2x2 if n == 4 else _worker_2)(rank, out, ckpt_dir)
    hvd.shutdown()
    np.savez(out_path, **out)


_WORLDS = {}


def _run_world(n, tmp_path_factory):
    if n not in _WORLDS:
        if n == 2:
            _run_world(4, tmp_path_factory)     # writes the checkpoint
        out = tmp_path_factory.mktemp(f"zero{n}")
        run_ranks(__file__, lambda r: ("--zero-worker", r, n,
                                       out / f"rank{r}.npz",
                                       _WORLDS["ckpt"]), n)
        _WORLDS[n] = [dict(np.load(out / f"rank{r}.npz")) for r in range(n)]
    return _WORLDS[n]


@pytest.fixture()
def world(tmp_path_factory):
    _WORLDS.setdefault("ckpt", str(tmp_path_factory.mktemp("zero_ckpt")))
    return _run_world(2, tmp_path_factory)


@pytest.fixture()
def world4(tmp_path_factory):
    _WORLDS.setdefault("ckpt", str(tmp_path_factory.mktemp("zero_ckpt")))
    return _run_world(4, tmp_path_factory)


# -- the JAX oracle -----------------------------------------------------------

def _jax_case(J, case, n, route=None):
    """The JAX surface of ``case`` under shard_map, each device one
    rank's rows; device 0's final (b, w). A guarded case reads
    ``_poisoned_y`` at ``POISON``'s step, as ``_port_case`` does."""
    from jax.sharding import Mesh, PartitionSpec as P

    kind, opt_name, *policy = case.split("/")
    optax, jo = J.optax, J.optim
    tx = optax.sgd(LR["sgd"], momentum=0.9) if opt_name == "sgd" \
        else optax.adam(LR["adam"])
    if route is None:
        axes, names = "z", ("z",)
        mesh = Mesh(np.array(J.jax.devices()[:n]), names)
        kw = {"axis_name": "z"}
    else:
        axes = names = ("cross", "local")
        mesh = Mesh(np.array(J.jax.devices()[:n]).reshape(2, 2), names)
        kw = {"route": jo.C.WirePlan.parse(route)}

    def loss(p, x, y):
        return ((x @ p["w"] + p["b"] - y) ** 2).mean()

    def body(x, y, y_bad):
        p = {"b": J.jnp.zeros(2), "w": J.jnp.zeros((8, 2))}
        if kind == "sharded":
            st = jo.sharded_init(tx, p, fusion_threshold_bytes=T, **kw)
            for _ in range(STEPS):
                g = J.jax.grad(loss)(p, x, y)
                u, st = jo.sharded_update(tx, g, st, p,
                                          fusion_threshold_bytes=T, **kw)
                p = optax.apply_updates(p, u)
        elif kind == "fsdp":
            f = jo.FSDPOptimizer(tx, fusion_threshold_bytes=T, **kw)
            sh = f.shard_params(p)
            st = f.init(sh)
            for _ in range(STEPS):
                g = J.jax.grad(loss)(f.gather_params(sh), x, y)
                sh, st = f.update(g, st, sh)
            p = f.gather_params(sh)
        else:
            stage = int(kind[1])
            z = jo.ZeroOptimizer(tx, zero_stage=stage,
                                 fusion_threshold_bytes=T,
                                 accum_steps=2 if stage == 2 else 1,
                                 nonfinite_policy=policy[0] if policy
                                 else None, **kw)
            if stage == 3:
                sh = z.shard_params(p)
                st = z.init(sh)
                for _ in range(STEPS):
                    _, gs = z.accumulate(loss)(sh, x, y)
                    sh, st = z.update(gs, st, sh)
                p = z.gather_params(sh)
            else:
                st = z.init(p)
                for t in range(STEPS):
                    if stage == 2:
                        _, g = z.accumulate(loss)(
                            p, x, y_bad if policy and t == POISON[1] else y)
                    else:
                        g = J.jax.grad(loss)(p, x, y)
                    u, st = z.update(g, st, p)
                    p = optax.apply_updates(p, u)
        return p["b"][None], p["w"][None]

    x, y = _problem()
    f = J.jax.jit(J.jax.shard_map(body, mesh=mesh,
                                  in_specs=(P(axes),) * 3,
                                  out_specs=P(axes), check_vma=False))
    jb, jw = f(J.jnp.asarray(x), J.jnp.asarray(y),
               J.jnp.asarray(_poisoned_y()))
    return np.asarray(jb)[0], np.asarray(jw)[0]


def _close(got, want, opt_name):
    if opt_name == "sgd":
        np.testing.assert_allclose(got, want, rtol=SGD_RTOL,
                                   atol=SGD_RTOL * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=ADAM_TOL * np.abs(want).max())


def _same_on_every_rank(ranks, key):
    for r in ranks:
        np.testing.assert_array_equal(r[key], ranks[0][key])


# -- against JAX ----------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_flat_surfaces_match_jax(J, world, case):
    """``sharded_update``, ``FSDPOptimizer`` and ``ZeroOptimizer`` stages
    1, 2 (``accum_steps=2``) and 3 over a flat world of 2, SGD with
    momentum to 1e-6 and Adam to 1e-5 of the JAX surface; the replicas
    bitwise equal."""
    jb, jw = _jax_case(J, case, 2)
    opt_name = case.split("/")[1]
    for key, want in (("b", jb), ("w", jw)):
        _same_on_every_rank(world, f"jax/{case}/{key}")
        _close(world[0][f"jax/{case}/{key}"], want, opt_name)
        assert np.abs(want).max() > 0


@pytest.mark.parametrize("case", GUARDED)
def test_stage2_accumulate_guard_matches_jax(J, world, case):
    """Stage 2, ``accum_steps=2``, under ``skip_step`` and ``zero``: a
    NaN in rank 1's second microbatch at one step. The step guards the
    reduced shard means, as the JAX ``ZeroOptimizer`` guards its shard
    gradients, so ``skip_step`` drops the step on every rank and ``zero``
    zeroes the reduced elements of ``b[0]`` and ``w[:, 0]``; both match
    the JAX surface with the same policy to 1e-6 and count one
    non-finite step."""
    jb, jw = _jax_case(J, case, 2)
    assert np.isfinite(jb).all() and np.isfinite(jw).all()
    for key, want in (("b", jb), ("w", jw)):
        _same_on_every_rank(world, f"jax/{case}/{key}")
        _close(world[0][f"jax/{case}/{key}"], want, "sgd")
    for r in world:
        assert r[f"jax/{case}/nonfinite"] == 1


@pytest.mark.parametrize("case", ROUTED)
def test_routed_surfaces_match_jax(J, world4, case):
    """The same over the 2x2 mesh with ``route="local:none,cross:none"``
    (the shard grid fast-axis-major over both axes) against the JAX
    surface on a (cross, local) mesh."""
    jb, jw = _jax_case(J, case, 4, route=PLAN)
    for key, want in (("b", jb), ("w", jw)):
        _same_on_every_rank(world4, f"jax/{case}/{key}")
        _close(world4[0][f"jax/{case}/{key}"], want, "sgd")


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_stage1_bitwise_equals_replicated_optimizer(world, name):
    """At n = 2 with ``none`` wires, stage 1 gives the replicated
    ``DistributedOptimizer``'s bits (same inner optimizer, ``foreach=
    False`` on both)."""
    for r in world:
        np.testing.assert_array_equal(r[f"bitwise/{name}/zero"],
                                      r[f"bitwise/{name}/rep"])
    assert np.abs(world[0][f"bitwise/{name}/zero"]).max() > 0


# -- int8_ef: the bound and the residual-sum invariant ---------------------------

def _ef_checks(ranks, tag, n, hosts=None):
    """SGD lr 1 on a linear loss: after step 1, ``-p`` is the reduced
    gradient, within the stochastic int8 bound of the exact mean (a
    block scale of each quantized addend, divided by n); after step 3,
    ``p + 3 * mean(G)`` is the residuals summed over the ranks over n."""
    g = np.concatenate(_probe_grads(n), axis=1).astype(np.float64)
    mean = g.mean(0)
    _same_on_every_rank(ranks, f"{tag}/p3")
    lead = ranks[0][f"{tag}/buckets"]
    nb = len(lead) // 2
    starts = {0: 0, 1: PROBE[0]}
    # Each quantized addend: a rank's gradient (flat) or a host's local
    # sum (the int8 cross hop of a route).
    addends = g if hosts is None else np.stack(
        [g[h * hosts:(h + 1) * hosts].sum(0) for h in range(n // hosts)])
    red = -ranks[0][f"{tag}/p1"].astype(np.float64)
    for i in range(nb):
        lo = starts[int(lead[i])]
        hi = lo + int(lead[nb + i])
        seg = slice(lo, hi)
        pad = (-(hi - lo)) % 4096
        s = np.stack([np.pad(np.abs(a[seg]), (0, pad)).reshape(-1, 4096)
                      .max(1) / 127 for a in addends]).sum(0)
        bound = np.repeat(s / n, 4096)[:hi - lo]
        err = np.abs(red[seg] - mean[seg])
        assert (err <= bound * (1 + 1e-5)).all()
        assert err.max() > 0
        rsum = sum(r[f"{tag}/res/{i}"].astype(np.float64) for r in ranks)
        p3 = ranks[0][f"{tag}/p3"][seg].astype(np.float64)
        closed = np.abs(p3 + STEPS * mean[seg] - rsum / n).max()
        assert closed <= 1e-5 * np.abs(STEPS * mean[seg]).max()
        assert np.abs(p3 + STEPS * mean[seg]).max() > 100 * closed
    for r in ranks:
        assert r[f"{tag}/ef_step"] == STEPS


def test_int8_ef_flat_bound_and_residual_invariant(world):
    _ef_checks(world, "ef", 2)


def test_int8_ef_routed_bound_and_residual_invariant(world4):
    """``route="local:none,cross:int8"`` + ``int8_ef``: int8 only on the
    cross hop, whose addends are the hosts' local sums."""
    _ef_checks(world4, "ef_route", 4, hosts=2)


def test_reference_routed_problem_distance_from_fp32(J, world4):
    """The JAX package's routed int8_ef problem (its seed, AdamW 1e-2, 6
    steps, ``local:none,cross:int8``) on the 2x2 mesh, against the fp32
    replicated trajectory: on native wires (``local:none,cross:none``)
    the port is that trajectory
    (1e-5 of the largest weight), so what int8_ef adds is the
    quantization's alone; that run trains (its loss falls) and its
    distance is printed (the reference test's limit is 0.35 of the
    largest weight)."""
    x, y = _ref_problem()
    optax, jnp = J.optax, J.jnp
    inner = optax.adamw(1e-2)
    p = {"w": jnp.zeros((64, 4)), "b": jnp.zeros(4)}
    s = inner.init(p)

    def loss(pp):
        return jnp.mean(jnp.stack([((jnp.asarray(x[r]) @ pp["w"] + pp["b"]
                                     - jnp.asarray(y[r])) ** 2).mean()
                                   for r in range(8)]))

    for _ in range(REF_STEPS):
        u, s = inner.update(J.jax.grad(loss)(p), s, p)
        p = optax.apply_updates(p, u)
    ref = np.asarray(p["w"])
    scale = np.abs(ref).max()
    for comp in ("int8_ef", "none"):
        _same_on_every_rank(world4, f"refprob/{comp}/w")
    exact = world4[0]["refprob/none/w"]
    np.testing.assert_allclose(exact, ref, rtol=0, atol=1e-5 * scale)
    got = {"w": world4[0]["refprob/int8_ef/w"],
           "b": world4[0]["refprob/int8_ef/b"]}
    assert np.isfinite(got["w"]).all()
    start = float(loss({"w": jnp.zeros((64, 4)), "b": jnp.zeros(4)}))
    assert float(loss({k: jnp.asarray(v) for k, v in got.items()})) < start
    dw = np.abs(got["w"] - ref).max()
    print(f"port routed int8_ef distance from fp32: dw={dw:.6g} "
          f"scale={scale:.6g} ratio={dw / scale:.4f}")


# -- the guard, the state round trip, the fingerprint ---------------------------

def test_guard_skip_moves_no_state(world):
    """Stage 3, Adam, ``skip_step``: a NaN on rank 1 at the second step;
    every rank skips it (the parameters across it bitwise unchanged), and
    the run ends with the bits of the run without that step: shards,
    moments and Adam's step counter."""
    for r in world:
        assert r["guard/across_skip"].all()
        assert list(r["guard/snapshot"]) == [1, STEPS]
        np.testing.assert_array_equal(r["guard/skip_p"], r["guard/clean_p"])
    keys = [k for k in world[0] if k.startswith("guard/skip/")]
    assert any(k.endswith("exp_avg") for k in keys)
    for k in keys:
        np.testing.assert_array_equal(
            world[0][k], world[0][k.replace("guard/skip/", "guard/clean/")])


def test_gather_reshard_round_trip_keeps_state(world):
    """``gather_state`` -> ``reshard_state`` -> ``gather_state``: the
    inner state bitwise, the residual's sum over the ranks bitwise (rank
    0 receives it, the others zeros)."""
    keys = [k for k in world[0] if k.startswith("trip/a/")]
    assert any("residual" in k for k in keys) and len(keys) > 4
    for r in world:
        for k in keys:
            np.testing.assert_array_equal(r[k], r[k.replace("trip/a/",
                                                            "trip/b/")])
    nb = len(world[0]["trip/res_local"]) // 2
    before = sum(r["trip/res_local"][:nb] for r in world)
    np.testing.assert_allclose(world[0]["trip/res_local"][nb:], before,
                               rtol=1e-6)
    assert (world[1]["trip/res_local"][nb:] == 0).all()


def test_sharded_fingerprint_replicated_and_sensitive(world):
    for r in world:
        np.testing.assert_array_equal(r["fp"], world[0]["fp"])
    assert not np.array_equal(world[0]["fp"][0], world[0]["fp"][1])


# -- the sharded checkpoint: saved on 2x2, restored on 2 -------------------------

def test_sharded_checkpoint_resize_drill(world4, world):
    """``save_sharded`` in the 2x2 world (a grid of 4), ``restore_sharded``
    in the world of 2 (a grid of 2) through one directory: the gathered
    state (Adam's moments and step, the int8_ef residual's sum, the
    parameters) bitwise equal."""
    keys = [k for k in world4[0] if k.startswith("ckpt/")]
    assert "ckpt/params" in keys and any("residual" in k for k in keys)
    for r in world:
        assert r["ckpt/step"] == CKPT_STEP
        for k in keys:
            np.testing.assert_array_equal(r[k], world4[0][k])


# -- one process: the surface and its refusals ----------------------------------

@pytest.fixture()
def world1():
    hvd.init(device="cpu")
    try:
        yield
    finally:
        hvd.shutdown()


def _params():
    return [torch.zeros(3, requires_grad=True),
            torch.zeros(4, 2, requires_grad=True)]


def test_zero_stage_dispatch_and_refusals(world1):
    opt = hvd.DistributedOptimizer(torch.optim.SGD(_params(), lr=0.1),
                                   zero_stage=2)
    assert isinstance(opt, hvd.ZeroOptimizer) and opt.zero_stage == 2
    for kw, match in (({"zero_stage": 4}, "zero_stage"),
                      ({"zero_stage": 1, "backward_passes_per_step": 2},
                       "backward_passes_per_step"),
                      ({"zero_stage": 1, "gradient_predivide_factor": 2.0},
                       "predivide")):
        with pytest.raises(ValueError, match=match):
            hvd.DistributedOptimizer(torch.optim.SGD(_params(), lr=0.1),
                                     **kw)
    with pytest.raises(ValueError, match="SUM/AVERAGE"):
        hvd.ZeroOptimizer(torch.optim.SGD(_params(), lr=0.1), zero_stage=2,
                          grad_op=hvd.Min)
    with pytest.raises(ValueError, match="zero_stage must be"):
        hvd.ZeroOptimizer(torch.optim.SGD(_params(), lr=0.1), zero_stage=0)
    a, b = _params()
    with pytest.raises(ValueError, match="one parameter group"):
        hvd.ShardedOptimizer(torch.optim.SGD(
            [{"params": [a]}, {"params": [b], "lr": 0.5}], lr=0.1))
    opt = hvd.ShardedOptimizer(torch.optim.SGD(
        [{"params": [a]}, {"params": [b]}], lr=0.1))
    assert len(opt.shard_state.shards) == 1
    with pytest.raises(ValueError, match="stage-3"):
        hvd.ZeroOptimizer(torch.optim.SGD(_params(), lr=0.1),
                          zero_stage=2).shard_params()
    big = torch.zeros(10)
    with pytest.raises(ValueError, match="storage"):
        hvd.ZeroOptimizer(torch.optim.SGD([big[2:].requires_grad_()],
                                          lr=0.1), zero_stage=3)
    fs = hvd.FSDPOptimizer(torch.optim.SGD(_params(), lr=0.1))
    with pytest.raises(ValueError, match="fixed"):
        fs.add_param_group({"params": [torch.zeros(5)]})
    with pytest.raises(ValueError, match="initialized"):
        hvd.shutdown()
        try:
            hvd.sharded_init(torch.optim.SGD(_params(), lr=0.1))
        finally:
            hvd.init(device="cpu")


def test_stage3_frees_and_restores_parameter_storage(world1):
    """At rest a stage-3 parameter owns no storage; ``gather_params``
    brings its values back; the resident gauge counts the shards."""
    a, b = _params()
    with torch.no_grad():
        a.copy_(torch.arange(3.0))
        b.copy_(torch.arange(8.0).reshape(4, 2))
    opt = hvd.ZeroOptimizer(torch.optim.SGD([a, b], lr=0.1), zero_stage=3)
    assert a.untyped_storage().nbytes() == 0
    assert b.untyped_storage().nbytes() == 0
    opt.gather_params()
    assert torch.equal(a, torch.arange(3.0))
    assert torch.equal(b, torch.arange(8.0).reshape(4, 2))
    (a.sum() + b.sum()).backward()
    opt.step()
    assert a.untyped_storage().nbytes() == 0 and a.grad is None
    opt.gather_params()
    assert torch.allclose(a, torch.arange(3.0) - 0.1)
    sd = opt.state_dict()
    assert [s.numel() for s in sd["shards"]] == [11]


@pytest.mark.parametrize("built", ["before", "after"])
@pytest.mark.parametrize("stage", [1, 3])
def test_lr_scheduler_sets_the_sharded_step(world1, stage, built):
    """A ``StepLR`` built on the optimizer before it is wrapped, or on
    the ``ZeroOptimizer`` after, halves the rate of each next step: on
    one rank the run has the bits of the same SGD and scheduler
    unwrapped, and the state dict carries the scheduled rate into the
    groups of the optimizer that loads it."""
    grads = [torch.arange(3.0) + 1, torch.full((4, 2), 0.5)]

    def run(wrap):
        a, b = _params()
        sgd = torch.optim.SGD([a, b], lr=1.0, foreach=False)
        def make(o):
            return torch.optim.lr_scheduler.StepLR(o, 1, gamma=0.5)

        sched = make(sgd) if built == "before" or not wrap else None
        opt = hvd.ZeroOptimizer(sgd, zero_stage=stage) if wrap else sgd
        sched = sched or make(opt)
        sharded = wrap and stage == 3
        seen = []
        for _ in range(3):
            if sharded:
                opt.gather_params()
            a.grad, b.grad = (g.clone() for g in grads)
            opt.step()
            sched.step()
            if sharded:
                opt.gather_params()
            seen.append(torch.cat([a.detach(), b.detach().reshape(-1)]))
            if sharded:
                opt.shard_params()
        return seen, opt.state_dict()

    with warnings.catch_warnings():
        # Before wrapping, the scheduler watches the wrapped optimizer's
        # step(), which the sharded step does not call.
        warnings.simplefilter("ignore", UserWarning)
        got, sd = run(True)
    want, _ = run(False)
    assert sd["param_groups"][0]["lr"] == 0.125
    fresh = hvd.ZeroOptimizer(torch.optim.SGD(_params(), lr=1.0),
                              zero_stage=stage)
    fresh.load_state_dict(sd)
    assert fresh.param_groups[0]["lr"] == 0.125
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(want[2] - want[1], (want[1] - want[0]) / 2)


def test_should_shard_update_and_threshold(world1, monkeypatch):
    params = [torch.zeros(1024)]
    assert hvd.auto_shard_threshold() == 256 * 1024 * 1024
    assert hvd.auto_shard_threshold(17) == 17
    assert not hvd.should_shard_update(params)           # one rank
    assert hvd.should_shard_update(params, size=2, threshold_bytes=4096)
    assert not hvd.should_shard_update(params, size=2,
                                       threshold_bytes=4097)
    hvd.shutdown()
    monkeypatch.setenv("HVD_TPU_AUTO_SHARD_THRESHOLD", "123")
    try:
        assert hvd.auto_shard_threshold() == 123
    finally:
        hvd.init(device="cpu")
    assert basics_config().auto_shard_threshold_bytes == 123


def basics_config():
    from horovod_tpu_torch.common import basics

    return basics.context().config


def test_capability_queries_and_surface_names(world1):
    """Horovod's capability queries report torch's own build; the 1a
    names and every name of the slice resolve from the package."""
    import torch.distributed as dist

    assert hvd.gloo_built() == dist.is_gloo_available()
    assert hvd.mpi_built() == dist.is_mpi_available()
    assert hvd.gloo_enabled()            # the CPU world reduces over gloo
    assert not hvd.mpi_enabled() and not hvd.xla_built()
    assert not hvd.ddl_built() and not hvd.ccl_built()
    assert hvd.cuda_built() == (torch.version.cuda is not None)
    assert hvd.rocm_built() == (getattr(torch.version, "hip", None)
                                is not None)
    assert isinstance(hvd.nccl_built(), int)
    with pytest.raises(ValueError, match="MPI"):
        hvd.mpi_threads_supported()
    axes = hvd.mesh_axes()
    assert [a.name for a in axes] == ["hvd"] and axes[0].size == 1
    assert hvd.AxisPhase("cross", "int8").wire == "int8"
    tree = {"a": torch.arange(4.0), "b": [torch.ones(2), 3]}
    out = hvd.broadcast_variables(tree)
    assert torch.equal(out["a"], tree["a"]) and out["a"] is not tree["a"]
    assert out["b"][1] == 3
    for name in ("ShardedOptimizer", "FSDPOptimizer", "ZeroOptimizer",
                 "sharded_init", "sharded_update", "auto_shard_threshold",
                 "should_shard_update", "save_sharded", "restore_sharded",
                 "broadcast_variables", "mesh_axes", "AxisPhase",
                 "mpi_built", "mpi_enabled", "mpi_threads_supported",
                 "gloo_built", "gloo_enabled", "nccl_built", "cuda_built",
                 "rocm_built", "ccl_built", "ddl_built", "xla_built"):
        assert callable(getattr(hvd, name)), name
        assert name in hvd.__all__, name
    from horovod_tpu_torch import optim

    assert optim.ShardedOptimizer is zero.ShardedOptimizer
    assert callable(integrity.sharded_fingerprint)


def test_sharded_checkpoint_walks_back_past_a_corrupt_step(world1, tmp_path):
    """A world of one: the newest step's piece corrupted, the restore
    walks back to the previous step; a Shard cut to another box and a
    Partial come back as their values."""
    d = str(tmp_path)
    for step, v in ((1, 1.0), (2, 2.0)):
        hvd.save_sharded({"s": ckpt.Shard(torch.full((4,), v), ((0, 4),),
                                          (4,)),
                          "p": ckpt.Partial(torch.full((3,), v)),
                          "k": v}, d, step)
    mgr = ckpt.CheckpointManager(f"{d}/rank0", writer=False)
    mgr._corrupt_step(2)
    tpl = {"s": ckpt.Shard(torch.zeros(2), ((1, 3),), (4,)),
           "p": ckpt.Partial(torch.zeros(3)), "k": 0.0}
    tree, step = hvd.restore_sharded(tpl, d)
    assert step == 1 and tree["k"] == 1.0
    assert torch.equal(tree["s"], torch.ones(2))
    assert torch.equal(tree["p"], torch.ones(3))
    with pytest.raises(ValueError, match="shape"):
        hvd.restore_sharded({"s": ckpt.Shard(torch.zeros(2), ((0, 2),),
                                             (5,)),
                             "p": tpl["p"], "k": 0.0}, d)


if __name__ == "__main__" and sys.argv[1:2] == ["--zero-worker"]:
    _zero_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                 sys.argv[5])
